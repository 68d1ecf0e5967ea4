"""Blockwise scaled-dot attention: the CUDA kernel and its plain version.

Replaces the Pallas TPU kernel
``bmnas_tpu/ops/kernels/attention.py::blockwise_scaled_dot_attention``:
``softmax(x y^T / sqrt(C)) y`` with the keys equal to the values, x
``(B, Lq, C)`` queries, y ``(B, Lk, C)``, the output fp32 whatever the input
type. The kernel (``csrc/attention.cu``, whose note says what bounds it on an
H100) keeps the ``(Lq, Lk)`` score matrix out of device memory with an online
softmax over key tiles, and runs both products on the tensor cores through
WMMA: 3xTF32 for fp32 inputs; for bf16 inputs the scores in one bf16 MMA
and ``P V`` in two TF32 products with P kept in fp32. A warp owns 16 query
rows; the launcher picks how many query groups and warps a block has and
the key tile (``geometry`` reads the pick). The wrapper allocates only the
output.

No entry point of the JAX package calls its kernel (only its tests do), and
none of the port calls this one: it is a public function, held against its
plain version as the JAX package holds its kernel.

* ``reference_attention``: the plain PyTorch version, dense, in fp32.
* ``blockwise_scaled_dot_attention``: checks its inputs on every device, then
  takes the plain version for CPU tensors and launches the kernel for CUDA
  tensors, or raises. ``block_q`` / ``block_k`` are validated and kept for
  the JAX signature; the kernel picks its own tiles.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from bmnas_tpu_torch.ops.kernels import LAUNCHES

MAX_C = 256  # 16 output tiles of 16 channels, four warps a group (attention.cu)


def reference_attention(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Dense ``softmax(x y^T / sqrt(C)) y`` in fp32."""
    x, y = x.float(), y.float()
    scores = torch.einsum("blc,bmc->blm", x, y) / math.sqrt(x.shape[-1])
    return torch.einsum("blm,bmc->blc", scores.softmax(dim=-1), y)


def _check(x: torch.Tensor, y: torch.Tensor, block_q, block_k) -> None:
    for name, v in (("block_q", block_q), ("block_k", block_k)):
        if not isinstance(v, int) or v <= 0:
            raise ValueError(f"attention: {name} must be a positive int, "
                             f"got {v!r}")
    if x.dim() != 3 or y.dim() != 3 or y.shape[0] != x.shape[0] \
            or y.shape[2] != x.shape[2]:
        raise ValueError(f"attention: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must be (B, Lq, C), (B, Lk, C)")
    if y.device != x.device:
        raise ValueError(f"attention: x is on {x.device}, y on {y.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or y.dtype != x.dtype:
        raise TypeError(f"attention: dtypes {x.dtype}, {y.dtype}; the kernel "
                        "takes fp32 or bf16, the same for x and y")
    B, Lq, C = x.shape
    if C % 8 or not 8 <= C <= MAX_C:
        raise ValueError(f"attention: C={C}, the kernel hosts multiples of 8 "
                         f"up to {MAX_C}")
    if Lq < 1 or y.shape[1] < 1:
        raise ValueError(f"attention: Lq={Lq}, Lk={y.shape[1]}; both must "
                         "be at least 1")
    for name, t in (("x", x), ("y", y)):
        if not t.is_contiguous():
            raise ValueError(f"attention: {name} must be contiguous")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/attention.cu`` on a loaded
    library: every pointer and the stream as ``c_void_p``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.attention_forward.argtypes = [ci, vp, vp, vp, ci, ci, ci, ci, vp]
    lib.attention_forward.restype = ci
    lib.attention_forward_geometry.argtypes = [ci, vp, vp, vp, ci, ci, ci,
                                               ci, ci, ci, ci, vp]
    lib.attention_forward_geometry.restype = ci
    lib.attention_geometry.argtypes = [ci, ci, ci, ci, ci, ci, ci, ci,
                                       ctypes.POINTER(ci)]
    lib.attention_geometry.restype = ci
    lib.attention_smem_bytes.argtypes = [ci, ci]
    lib.attention_smem_bytes.restype = ctypes.c_size_t
    lib.attention_error_string.argtypes = [ci]
    lib.attention_error_string.restype = ctypes.c_char_p
    return lib


def geometry(lib: ctypes.CDLL, B: int, Lq: int, Lk: int, C: int,
             itemsize: int, wq: int = 0, wc: int = 0, bk: int = 0) -> dict:
    """The launch geometry ``attention_forward`` takes for a call: query
    groups of 16 rows a block (``wq``), warps a group (``wc``), keys a tile
    (``bk``), threads and blocks, blocks an SM holds, and bytes of shared
    memory a block. A nonzero ``wq``, ``wc`` or ``bk`` fixes that part; 0
    lets the launcher pick, as the wrapper does."""
    geom = (ctypes.c_int * 7)()
    rc = lib.attention_geometry(B, Lq, Lk, C, itemsize, wq, wc, bk, geom)
    if rc != 0:
        raise ValueError(f"attention: no geometry hosts B={B}, Lq={Lq}, "
                         f"Lk={Lk}, C={C}, wq={wq}, wc={wc}, bk={bk}")
    return dict(zip(("wq", "wc", "bk", "threads", "blocks", "blocks_per_sm",
                     "smem_bytes"), geom))


def launch(lib: ctypes.CDLL, x: torch.Tensor, y: torch.Tensor,
           stream: Optional[int], wq: int = 0, wc: int = 0,
           bk: int = 0) -> torch.Tensor:
    """Call ``attention_forward`` of a bound library on checked tensors and
    return the fp32 output; raises if the launch returns an error. A
    nonzero ``wq``, ``wc`` or ``bk`` fixes that part of the geometry
    (``attention_forward_geometry``), as for ``geometry``."""
    B, Lq, C = x.shape
    out = torch.empty(B, Lq, C, dtype=torch.float32, device=x.device)
    args = (0 if x.dtype == torch.float32 else 1, x.data_ptr(),
            y.data_ptr(), out.data_ptr(), B, Lq, y.shape[1], C)
    if wq or wc or bk:
        rc = lib.attention_forward_geometry(*args, wq, wc, bk, stream)
    else:
        rc = lib.attention_forward(*args, stream)
    if rc != 0:
        raise RuntimeError("attention kernel launch failed: "
                           + lib.attention_error_string(rc).decode())
    return out


def blockwise_scaled_dot_attention(x: torch.Tensor, y: torch.Tensor,
                                   block_q: int = 128, block_k: int = 128
                                   ) -> torch.Tensor:
    """``softmax(x y^T / sqrt(C)) y`` in fp32 without the score matrix: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors. No
    fallback: a CUDA call launches or raises. The kernel has no backward,
    so a CUDA call that would need one raises too."""
    _check(x, y, block_q, block_k)
    if x.device.type == "cpu":
        return reference_attention(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"attention: no kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or y.requires_grad):
        raise RuntimeError("attention: the kernel has no backward; call it "
                           "under torch.no_grad()")
    for name, t in (("x", x), ("y", y)):
        if t.data_ptr() % 16:
            raise ValueError(f"attention: {name} must be 16-byte aligned")
    if x.shape[0] == 0:
        return torch.empty(x.shape, dtype=torch.float32, device=x.device)
    from bmnas_tpu_torch.ops.kernels import _build
    with torch.cuda.device(x.device):
        out = launch(_build.load("attention", bind), x, y,
                     torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["attention"] += 1
    return out
