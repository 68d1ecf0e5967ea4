"""Port of bmnas_tpu/ops (see the package docstring)."""
