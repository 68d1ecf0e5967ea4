"""Port of bmnas_tpu/models (see the package docstring)."""
