"""bmnas-tpu-torch: the PyTorch/CUDA port of bmnas-tpu for NVIDIA Hopper.

The package mirrors the module layout of ``bmnas_tpu`` (the JAX reference)
so each counterpart sits at the same relative path. It imports torch,
numpy and the standard library only; nothing of JAX and nothing of
``bmnas_tpu``.

Public functions keep the reference's channels-last ``(B, L, C)`` layout
and NHWC image batches, so weights map one to one
(``bmnas_tpu_torch.utils.convert``).

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); with no CUDA device and no explicit
CPU request they raise (``bmnas_tpu_torch.device.resolve_device``).
"""

__version__ = "0.1.0"
