"""Port of bmnas_tpu/cli (see the package docstring)."""
