"""Port of bmnas_tpu/utils (see the package docstring)."""
