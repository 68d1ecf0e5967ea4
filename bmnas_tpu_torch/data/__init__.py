"""Port of bmnas_tpu/data (see the package docstring)."""
