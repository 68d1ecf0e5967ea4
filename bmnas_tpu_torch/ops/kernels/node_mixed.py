"""The fusion-cell CUDA kernels of the port and their plain versions.

Two kernels replace the two Pallas TPU kernels of
``bmnas_tpu/ops/kernels/node_mixed.py``; each source note (under
``bmnas_tpu_torch/csrc``) says what bounds it on an H100 and how the design
answers.

* The found cell in eval mode, ``found_node_cell_multi_fused`` ->
  ``csrc/found_cell.cu``: ``found_node_cell_reference`` is the plain
  PyTorch version, ``found_node_cell_fused`` the wrapper.
* The supernet's mixed op in eval mode, ``node_mixed_op_fused`` ->
  ``csrc/node_mixed.cu``: ``node_mixed_op_reference`` is the plain version,
  ``node_mixed_op_fused`` the wrapper, ``params_from_module`` folds a
  ``NodeMixedOp``'s BatchNorms into its dense weights.

A wrapper given a CPU tensor takes the plain version; given a CUDA tensor it
launches the kernel or raises. The CPU tests hold the plain versions against
the JAX kernels; ``chip_smoke.py`` holds the CUDA kernels against the plain
versions on the card.

Found-cell semantics (eval mode, BatchNorms folded into the dense weights,
dropout off): S chained inner steps, each one static branch over two states
picked by static skip/none edges (Sum; attention + per-sample LayerNorm;
GLU; ConcatFC + ReLU), then for ``multiplier != 1`` concat of the last m
states -> out_conv -> ReLU, then ``+ x`` and a per-sample LayerNorm.
``steps_cfg`` is the JAX kernel's: per step ``(branch, (skip_x, idx_x),
(skip_y, idx_y))``.

Mixed-op semantics (eval mode, BatchNorms folded, dropout off):
``g0 (x + y) + g1 LN(attn(x, y)) + g2 GLU([x|y]) + g3 ReLU(FC([x|y]))`` with
``gammas`` the four softmaxed branch weights, kept on the device.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
import threading
from typing import Optional, Sequence, Tuple

import torch

from bmnas_tpu_torch.ops.kernels import LAUNCHES
from bmnas_tpu_torch.ops.layers import layer_norm_2d

# branch index per inner-op name (STEP_STEP_PRIMITIVES order; the legacy
# 'cat_conv_relu' is ConcatFC)
FUSABLE_STEP_OPS = {"Sum": 0, "ScaleDotAttn": 1, "LinearGLU": 2,
                    "ConcatFC": 3, "cat_conv_relu": 3}
FUSABLE_EDGES = ("skip", "none")
MAX_STEPS = 4  # kMaxSteps in csrc/found_cell.cu
MAX_C = 256  # widest C of the cell kernels (found_cell.cu, node_mixed.cu)
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper
# rows of a found-cell GEMM block: 8 units of two 16-row tiles (one sample
# a block at the least), one a GEMM warp (csrc/cell_gemm.cuh)
FOUND_MAX_L = 256
# rows of one mixed-op block: 8 work units of two 16-row tiles (and three
# 16-column tiles), one a GEMM warp (csrc/node_mixed.cu)
MIXED_MAX_L = 256

StepsCfg = Tuple[Tuple[int, Tuple[bool, int], Tuple[bool, int]], ...]


@dataclasses.dataclass
class FoundCellParams:
    """Folded eval-mode parameters of one found cell, stacked over steps.

    Dense weights are in (in, out) layout. A step's unused branch slots are
    zeros and never read.
    """
    ln1_scale: torch.Tensor   # (S, L, C) attention LayerNorm
    ln1_bias: torch.Tensor    # (S, L, C)
    glu_kernel: torch.Tensor  # (S, 2C, 2C) BN folded
    glu_bias: torch.Tensor    # (S, 2C)
    cfc_kernel: torch.Tensor  # (S, 2C, C) BN folded
    cfc_bias: torch.Tensor    # (S, C)
    oc_kernel: Optional[torch.Tensor]  # (m*C, C) BN folded, None for m = 1
    oc_bias: Optional[torch.Tensor]    # (C,)
    ln2_scale: torch.Tensor   # (L, C) output LayerNorm
    ln2_bias: torch.Tensor    # (L, C)

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def to(self, *args, **kwargs) -> "FoundCellParams":
        return FoundCellParams(*[
            None if t is None else t.to(*args, **kwargs).contiguous()
            for t in self.tensors()])


def fuse_bn_into_dense(kernel, bias, scale, bn_bias, mean, var,
                       eps: float = 1e-5):
    """Fold an eval-mode BatchNorm after a dense layer ((in, out) kernel):
    y = scale * (xW + b - mean) / sqrt(var + eps) + bn_bias."""
    inv = scale / torch.sqrt(var + eps)
    return kernel * inv[None, :], (bias - mean) * inv + bn_bias


def found_cell_steps_cfg(inner_edges, inner_steps) -> StepsCfg:
    """Per-step kernel configuration from a StepGenotype."""
    cfg = []
    for i, op in enumerate(inner_steps):
        (kx, ix), (ky, iy) = inner_edges[2 * i], inner_edges[2 * i + 1]
        cfg.append((FUSABLE_STEP_OPS[op], (kx == "skip", ix),
                    (ky == "skip", iy)))
    return tuple(cfg)


def found_cell_phases(steps_cfg: StepsCfg, multiplier: int) -> list:
    """The kernel's phases, one launch each (``plan_phases`` in
    ``csrc/found_cell.cu``): one a GLU or ConcatFC step, one for the
    out-conv when ``multiplier != 1``, and a last one for the residual and
    the LayerNorm, unless no step follows the last GEMM: then that GEMM's
    phase ends the cell (``fused``). Each phase runs the non-GEMM steps
    before its GEMM. Per phase: ``kind`` ('glu', 'fc', 'out_conv',
    'final'), ``fused``, ``nsrc`` (the GEMM's sources), ``slots`` (the
    states it keeps in shared memory, the zeros of a 'none' edge among
    them), ``inputs`` (x and y among the states it reads into them) and
    ``attn`` (an attention among its steps)."""
    S = len(steps_cfg)
    cuts, first = [], 0
    for s, (branch, _, _) in enumerate(steps_cfg):
        if branch >= 2:
            cuts.append(("glu" if branch == 2 else "fc", first, s, 2))
            first = s + 1
    if multiplier != 1:
        cuts.append(("out_conv", first, S, multiplier))
        first = S
    cuts.append(("final", first, S, 0))
    phases = []
    for kind, a, z, nsrc in cuts:
        local, zero, attn = set(), False, False
        for s in range(a, z):
            branch, (sx, ix), (sy, iy) = steps_cfg[s]
            for skip, i in ((sx, ix), (sy, iy)):
                if skip:
                    local.add(i)
                else:
                    zero = True
            local.add(s + 2)
            attn = attn or branch == 1
        if kind == "final":
            local |= {0, S + 2 if multiplier != 1 else S + 1}
        phases.append(dict(kind=kind, fused=False, nsrc=nsrc,
                           slots=len(local) + zero,
                           inputs=len(local & {0, 1}), attn=attn))
    if len(phases) >= 2 and cuts[-1][1] == cuts[-1][2]:
        phases.pop()
        phases[-1]["fused"] = True
    return phases


def found_cell_smem_bytes(L: int, C: int, steps_cfg: StepsCfg,
                          multiplier: int, itemsize: int = 4) -> int:
    """Bytes of shared memory of the cell's largest phase at its smallest
    geometry (one sample a block, 16 columns, a ring of 16-row weight
    K-tiles), as ``found_cell_smem_bytes`` in ``csrc/found_cell.cu``
    computes them: the kernel hosts the cell if they fit."""
    a32 = lambda n: -(-n // 32) * 32  # noqa: E731
    kk = 8 if itemsize == 4 else 16  # the MMA step
    worst = 0
    for ph in found_cell_phases(steps_cfg, multiplier):
        n = a32(ph["slots"] * L * (C + 4) * 4)
        if itemsize != 4:  # bf16 x and y as they came, before widening
            n += a32(ph["inputs"] * L * C * itemsize)
        if ph["attn"]:
            n += a32(L * C * 4) + a32(L * L * 4)
        n += a32((2 + 16) * 4 * 4)  # statistics, a slot a warp and sample
        if ph["kind"] == "final" or ph["fused"]:
            n += a32(2 * L * C * itemsize)  # the LayerNorm's affine
        if ph["fused"]:
            n += a32(L * C * itemsize)  # the residual's rows
        if ph["kind"] != "final":
            K = -(-ph["nsrc"] * C // kk) * kk
            sets = 2 if ph["kind"] == "glu" else 1
            rows = -(-L // 16) * 16
            units = -(-(rows // 16) // 2)
            splits = 1 if units >= 8 else 8 // units
            kt = min(16, K)
            ring = min(-(-K // kt), 4) * kt * (sets * 16 + 16 // itemsize)
            n += a32(sets * 16 * itemsize)  # the biases
            n += a32(rows * (K + 16 // itemsize) * itemsize)
            n += max(a32(max(ring * itemsize, splits * rows * sets * 16 * 4)),
                     a32(L * C * 4) if ph["fused"] else 0)
        worst = max(worst, n)
    return worst


def found_cell_blocker(inner_edges, inner_steps, C: int = 8, L: int = 8,
                       multiplier: int = 1) -> str:
    """'' when the kernel can host the genotype at width C and length L,
    else the reason."""
    if C % 8 or C > MAX_C:
        return f"C={C} is not a multiple of 8 up to {MAX_C}"
    bad_ops = [o for o in inner_steps if o not in FUSABLE_STEP_OPS]
    if bad_ops:
        return f"inner op(s) {bad_ops} not in {sorted(FUSABLE_STEP_OPS)}"
    bad_edges = [k for k, _ in inner_edges if k not in FUSABLE_EDGES]
    if bad_edges:
        return f"inner edge op(s) {bad_edges} not in {FUSABLE_EDGES}"
    if len(inner_steps) > MAX_STEPS:
        return f"{len(inner_steps)} inner steps > {MAX_STEPS}"
    return _size_blocker(
        L, C, found_cell_steps_cfg(inner_edges, inner_steps), multiplier)


@functools.lru_cache(maxsize=256)
def _size_blocker(L: int, C: int, steps_cfg: StepsCfg,
                  multiplier: int) -> str:
    """'' when the kernel's blocks fit L and C for these steps (in fp32,
    which needs more shared memory than bf16), else the reason."""
    phases = found_cell_phases(steps_cfg, multiplier)
    if L > FOUND_MAX_L and any(p["kind"] != "final" for p in phases):
        return f"L={L} > {FOUND_MAX_L} rows of a GEMM block"
    smem = found_cell_smem_bytes(L, C, steps_cfg, multiplier)
    if smem > SMEM_LIMIT:
        return (f"L={L}, C={C} needs {smem} B of shared memory a block > "
                f"{SMEM_LIMIT}")
    return ""


def found_node_cell_reference(x: torch.Tensor, y: torch.Tensor,
                              p: FoundCellParams, steps_cfg: StepsCfg,
                              multiplier: int = 1, eps: float = 1e-5
                              ) -> torch.Tensor:
    """Plain PyTorch version: fp32 arithmetic, output in x's dtype."""
    dtype = x.dtype
    f = lambda t: t.float()  # noqa: E731
    x, y = f(x), f(y)
    C = x.shape[-1]
    zeros = torch.zeros_like(x)
    states = [x, y]
    for i, (branch, (skip_x, idx_x), (skip_y, idx_y)) in enumerate(steps_cfg):
        a = states[idx_x] if skip_x else zeros
        b = states[idx_y] if skip_y else zeros
        if branch == 0:
            o = a + b
        elif branch == 1:
            scores = torch.einsum("blc,bmc->blm", a, b) / math.sqrt(C)
            o = torch.einsum("blm,bmc->blc", scores.softmax(dim=-1), b)
            o = layer_norm_2d(o, f(p.ln1_scale[i]), f(p.ln1_bias[i]), eps)
        elif branch == 2:
            h = torch.cat([a, b], -1) @ f(p.glu_kernel[i]) + f(p.glu_bias[i])
            o = h[..., :C] * torch.sigmoid(h[..., C:])
        else:
            h = torch.cat([a, b], -1) @ f(p.cfc_kernel[i]) + f(p.cfc_bias[i])
            o = torch.relu(h)
        states.append(o)
    if multiplier == 1:
        o = states[-1]
    else:
        o = torch.relu(torch.cat(states[-multiplier:], -1) @ f(p.oc_kernel)
                       + f(p.oc_bias))
    o = layer_norm_2d(o + x, f(p.ln2_scale), f(p.ln2_bias), eps)
    return o.to(dtype)


def found_cell_scratch_numel(B: int, L: int, C: int, S: int) -> int:
    """fp32 elements of the found cell's scratch: the intermediate states
    (one a step and the out-conv's output), B x L x C each."""
    return (S + 1) * B * L * C


def _check_scratch(scratch: torch.Tensor, x: torch.Tensor, S: int):
    B, L, C = x.shape
    n = found_cell_scratch_numel(B, L, C, S)
    if scratch.dtype != torch.float32 or scratch.device != x.device:
        raise TypeError(f"found_cell: scratch is {scratch.dtype} on "
                        f"{scratch.device}, must be fp32 on {x.device}")
    if scratch.numel() != n:
        raise ValueError(f"found_cell: scratch holds {scratch.numel()} "
                         f"elements, the call needs {n}")
    if not scratch.is_contiguous() or scratch.data_ptr() % 16:
        raise ValueError("found_cell: scratch must be contiguous and "
                         "16-byte aligned")


def _check_tickets(tickets: torch.Tensor, x: torch.Tensor):
    if tickets.dtype != torch.int32 or tickets.device != x.device:
        raise TypeError(f"found_cell: tickets are {tickets.dtype} on "
                        f"{tickets.device}, must be int32 on {x.device}")
    if tickets.numel() < x.shape[0] or not tickets.is_contiguous():
        raise ValueError(f"found_cell: tickets must be {x.shape[0]} "
                         "contiguous ints at least")


# the tickets and the scratch of each (device, stream): calls on one stream
# take turns, each call leaves the tickets at 0 and writes each scratch
# element before it reads it, so one pair serves every call on the stream
_STREAM_BUFFERS: dict = {}
_STREAM_BUFFERS_LOCK = threading.Lock()


def _stream_buffers(x: torch.Tensor, stream: int, S: int):
    """The zeroed tickets (at least B) and the scratch (exactly
    ``found_cell_scratch_numel`` elements) of x's device and this
    stream."""
    B, L, C = x.shape
    n = found_cell_scratch_numel(B, L, C, S)
    key = (x.device, stream)
    with _STREAM_BUFFERS_LOCK:
        t, s = _STREAM_BUFFERS.get(key, (None, None))
        if t is None or t.numel() < B:
            t = torch.zeros(max(B, 128), dtype=torch.int32, device=x.device)
        if s is None or s.numel() < n:
            s = torch.empty(n, dtype=torch.float32, device=x.device)
        _STREAM_BUFFERS[key] = (t, s)
    return t, s[:n]


def _check(x, y, p: FoundCellParams, steps_cfg: StepsCfg, multiplier: int,
           scratch: Optional[torch.Tensor] = None):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"found_cell: dtype {x.dtype} not in (fp32, bf16)")
    if x.dim() != 3 or y.shape != x.shape:
        raise ValueError(f"found_cell: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must both be (B, L, C)")
    B, L, C = x.shape
    if C % 8 or C > MAX_C:
        raise ValueError(f"found_cell: C={C}, the kernel hosts multiples "
                         f"of 8 up to {MAX_C}")
    S = len(steps_cfg)
    if not 1 <= S <= MAX_STEPS:
        raise ValueError(f"found_cell: {S} steps, the kernel hosts "
                         f"1..{MAX_STEPS}")
    if not 1 <= multiplier <= S + 2:
        raise ValueError(f"found_cell: multiplier {multiplier} not in "
                         f"1..{S + 2}")
    for i, (branch, (_, ix), (_, iy)) in enumerate(steps_cfg):
        if branch not in (0, 1, 2, 3) or not (0 <= ix < 2 + i
                                              and 0 <= iy < 2 + i):
            raise ValueError(f"found_cell: bad step {i}: {steps_cfg[i]}")
    want = {"ln1_scale": (S, L, C), "ln1_bias": (S, L, C),
            "glu_kernel": (S, 2 * C, 2 * C), "glu_bias": (S, 2 * C),
            "cfc_kernel": (S, 2 * C, C), "cfc_bias": (S, C),
            "ln2_scale": (L, C), "ln2_bias": (L, C)}
    if multiplier != 1:
        want.update(oc_kernel=(multiplier * C, C), oc_bias=(C,))
    for name, shape in want.items():
        t = getattr(p, name)
        if t is None or tuple(t.shape) != shape:
            raise ValueError(f"found_cell: {name} must be {shape}, got "
                             f"{None if t is None else tuple(t.shape)}")
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"found_cell: {name} is {t.dtype} on "
                            f"{t.device}, x is {x.dtype} on {x.device}")
    for name, t in [("x", x), ("y", y)] + [
            (n, getattr(p, n)) for n in want]:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"found_cell: {name} must be contiguous and "
                             "16-byte aligned")
    if y.dtype != x.dtype or y.device != x.device:
        raise TypeError("found_cell: x and y differ in dtype or device")
    if scratch is not None:
        _check_scratch(scratch, x, S)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/found_cell.cu`` on a loaded
    library: every pointer and the stream as ``c_void_p``."""
    vp, ci, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.found_cell_forward.argtypes = [
        ci, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, pi, pi, pi,
        ctypes.POINTER(vp), ctypes.c_float, ci, ci, ci, vp]
    lib.found_cell_forward.restype = ci
    lib.found_cell_smem_bytes.argtypes = [ci, ci, ci, ci, pi, pi, pi, ci]
    lib.found_cell_smem_bytes.restype = ctypes.c_size_t
    lib.found_cell_geometry.argtypes = [ci, ci, ci, ci, ci, pi, pi, pi, ci,
                                        ci, ci, ci, pi, pi]
    lib.found_cell_geometry.restype = ci
    lib.found_cell_error_string.argtypes = [ci]
    lib.found_cell_error_string.restype = ctypes.c_char_p
    return lib


def _steps_arrays(steps_cfg: StepsCfg):
    """The C interface's per-step arrays: branch, x source, y source (-1
    for a 'none' edge)."""
    S = len(steps_cfg)
    ints = lambda v: (ctypes.c_int * S)(*v)  # noqa: E731
    return (ints([b for b, _, _ in steps_cfg]),
            ints([ix if sx else -1 for _, (sx, ix), _ in steps_cfg]),
            ints([iy if sy else -1 for _, _, (sy, iy) in steps_cfg]))


FOUND_PHASE_KINDS = ("final", "glu", "fc", "out_conv", "whole")
# a call's design (``Design`` in csrc/found_cell.cu): the launcher's pick,
# the phases, or the whole cell in one block a sample
FOUND_DESIGNS = {"auto": 0, "phases": 1, "whole": 2}
_GEOM_FIELDS = ("kind", "step", "samples_per_block", "cols_per_block",
                "k_tile", "k_tiles_resident", "blocks", "threads",
                "blocks_per_sm", "smem_bytes", "fused")


def found_cell_geometry(lib: ctypes.CDLL, B: int, L: int, C: int,
                        steps_cfg: StepsCfg, multiplier: int, itemsize: int,
                        samples_per_block: int = 0, cols_per_block: int = 0,
                        design: str = "auto") -> list:
    """The launches ``found_cell_forward`` makes for a call, one dict a
    phase: its kind ('glu', 'fc', 'out_conv', 'final', or 'whole': the
    whole cell in one block a sample) and GEMM step (-1 for none), samples
    and output columns a block (the last phase and 'whole': one sample and
    all C columns), weight rows a K-tile and K-tiles in shared memory at
    once (0 without a GEMM; 'whole' streams its weights through two),
    blocks, threads, blocks an SM holds, bytes of shared memory a block,
    and whether the phase ends the cell (``fused``: its group's last block
    adds x and normalizes). 0 and ``design`` 'auto' let the launcher pick,
    as the wrapper does; ``design`` 'phases' or 'whole' fixes the
    design."""
    n = len(_GEOM_FIELDS)
    geom = (ctypes.c_int * (n * (MAX_STEPS + 2)))()
    count = ctypes.c_int(0)
    rc = lib.found_cell_geometry(
        B, L, C, len(steps_cfg), multiplier, *_steps_arrays(steps_cfg),
        itemsize, samples_per_block, cols_per_block, FOUND_DESIGNS[design],
        geom, ctypes.byref(count))
    if rc != 0:
        raise ValueError(f"found_cell: no geometry hosts B={B}, L={L}, "
                         f"C={C}, S={samples_per_block}, "
                         f"nt={cols_per_block}, design={design}")
    out = []
    for i in range(count.value):
        d = dict(zip(_GEOM_FIELDS, geom[i * n:(i + 1) * n]))
        d["kind"] = FOUND_PHASE_KINDS[d["kind"]]
        out.append(d)
    return out


def launch(lib: ctypes.CDLL, x: torch.Tensor, y: torch.Tensor,
           p: FoundCellParams, steps_cfg: StepsCfg, multiplier: int,
           eps: float, stream: Optional[int],
           scratch: Optional[torch.Tensor] = None,
           samples_per_block: int = 0, cols_per_block: int = 0,
           tickets: Optional[torch.Tensor] = None,
           design: str = "auto") -> torch.Tensor:
    """Call ``found_cell_forward`` of a bound library on checked tensors
    and return the output; raises if a launch returns an error. ``scratch``
    holds the intermediate states (``found_cell_scratch_numel`` fp32
    elements on x's device; allocated here when None); ``tickets`` B int32
    zeros on x's device that the call leaves at zero (allocated here when
    None; the wrapper keeps one buffer a stream).
    ``samples_per_block`` (1, 2 or 4) and ``cols_per_block`` (16 or 32) fix
    the GEMM phases' geometry; 0 lets the launcher pick from B. ``design``
    ('auto', 'phases' or 'whole') as in ``found_cell_geometry``."""
    B, L, C = x.shape
    S = len(steps_cfg)
    reason = _size_blocker(L, C, steps_cfg, multiplier)
    if reason:
        raise ValueError(f"found_cell: the kernel cannot host this cell: "
                         f"{reason}")
    if scratch is None:
        scratch = torch.empty(found_cell_scratch_numel(B, L, C, S),
                              dtype=torch.float32, device=x.device)
    _check_scratch(scratch, x, S)
    if tickets is None:
        tickets = torch.zeros(B, dtype=torch.int32, device=x.device)
    _check_tickets(tickets, x)
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * 10)(*[
        None if t is None else t.data_ptr() for t in p.tensors()])
    dtype_code = 0 if x.dtype == torch.float32 else 1
    rc = lib.found_cell_forward(
        dtype_code, x.data_ptr(), y.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), tickets.data_ptr(), B, L, C, S, multiplier,
        *_steps_arrays(steps_cfg), ptrs, float(eps), samples_per_block,
        cols_per_block, FOUND_DESIGNS[design], stream)
    if rc != 0:
        raise RuntimeError("found_cell kernel launch failed: "
                           + lib.found_cell_error_string(rc).decode())
    return out


def found_node_cell_fused(x: torch.Tensor, y: torch.Tensor,
                          p: FoundCellParams, steps_cfg: StepsCfg,
                          multiplier: int = 1, eps: float = 1e-5
                          ) -> torch.Tensor:
    """The found cell: the CUDA kernel for CUDA tensors (one launch a phase
    of the cell, counted once a call), the plain version for CPU tensors.
    No fallback: a CUDA call launches or raises."""
    if x.device.type == "cpu":
        return found_node_cell_reference(x, y, p, steps_cfg, multiplier, eps)
    if x.device.type != "cuda":
        raise ValueError(f"found_cell: no kernel for device {x.device}")
    _check(x, y, p, steps_cfg, multiplier)
    if x.shape[0] == 0:
        return torch.empty_like(x)
    from bmnas_tpu_torch.ops.kernels import _build
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tickets, scratch = _stream_buffers(x, stream, len(steps_cfg))
        out = launch(_build.load("found_cell", bind), x, y, p, steps_cfg,
                     multiplier, eps, stream, scratch, tickets=tickets)
    LAUNCHES["found_cell"] += 1
    return out


def stack_step_params(steps: Sequence[dict], L: int, C: int,
                      like: torch.Tensor) -> dict:
    """Stack per-step folded tensors into FoundCellParams fields; a step's
    missing branch tensors are zeros. ``steps[i]`` may hold ln1_scale,
    ln1_bias, glu_kernel, glu_bias, cfc_kernel, cfc_bias."""
    shapes = {"ln1_scale": (L, C), "ln1_bias": (L, C),
              "glu_kernel": (2 * C, 2 * C), "glu_bias": (2 * C,),
              "cfc_kernel": (2 * C, C), "cfc_bias": (C,)}
    z = lambda s: torch.zeros(s, dtype=like.dtype, device=like.device)  # noqa
    return {k: torch.stack([st.get(k, z(s)) for st in steps])
            for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# The supernet's mixed op in eval mode (csrc/node_mixed.cu)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class NodeMixedParams:
    """Folded eval-mode parameters of one NodeMixedOp; dense weights in
    (in, out) layout."""
    ln_scale: torch.Tensor    # (L, C) attention LayerNorm
    ln_bias: torch.Tensor     # (L, C)
    glu_kernel: torch.Tensor  # (2C, 2C) BN folded
    glu_bias: torch.Tensor    # (2C,)
    cfc_kernel: torch.Tensor  # (2C, C) BN folded
    cfc_bias: torch.Tensor    # (C,)

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def to(self, *args, **kwargs) -> "NodeMixedParams":
        return NodeMixedParams(*[t.to(*args, **kwargs).contiguous()
                                 for t in self.tensors()])


def _fold_dense_bn(dense, bn):
    """(in, out) fp32 kernel and bias of Linear -> eval BatchNorm."""
    f = lambda t: t.detach().float()  # noqa: E731
    return fuse_bn_into_dense(f(dense.weight).t(), f(dense.bias),
                              f(bn.weight), f(bn.bias), f(bn.running_mean),
                              f(bn.running_var), bn.eps)


def params_from_module(op) -> NodeMixedParams:
    """Counterpart of the JAX ``params_from_flax``: a NodeMixedOp's
    (``ops.fusion_ops.NodeMixedOp``) two BatchNorms folded into its dense
    weights, in fp32 and stored in the op's parameter dtype. The result is
    a copy: it never aliases a parameter."""
    with torch.no_grad():
        ln = op.ScaledDotAttn_0.LayerNorm2D_0
        glu_k, glu_b = _fold_dense_bn(op.LinearGLU_0.Dense_0,
                                      op.LinearGLU_0.BatchNorm_0)
        cfc_k, cfc_b = _fold_dense_bn(op.ConcatFC_0.Dense_0,
                                      op.ConcatFC_0.BatchNorm_0)
        p = NodeMixedParams(
            ln_scale=ln.weight.detach().float().clone(),
            ln_bias=ln.bias.detach().float().clone(),
            glu_kernel=glu_k, glu_bias=glu_b,
            cfc_kernel=cfc_k, cfc_bias=cfc_b)
        return p.to(dtype=ln.weight.dtype)


def node_mixed_op_reference(x: torch.Tensor, y: torch.Tensor,
                            gammas: torch.Tensor, p: NodeMixedParams,
                            eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version: fp32 arithmetic, output in x's dtype."""
    dtype = x.dtype
    f = lambda t: t.float()  # noqa: E731
    x, y, g = f(x), f(y), f(gammas)
    C = x.shape[-1]
    scores = torch.einsum("blc,bmc->blm", x, y) / math.sqrt(C)
    a = torch.einsum("blm,bmc->blc", scores.softmax(dim=-1), y)
    a = layer_norm_2d(a, f(p.ln_scale), f(p.ln_bias), eps)
    cat = torch.cat([x, y], -1)
    h = cat @ f(p.glu_kernel) + f(p.glu_bias)
    glu = h[..., :C] * torch.sigmoid(h[..., C:])
    c = torch.relu(cat @ f(p.cfc_kernel) + f(p.cfc_bias))
    return (g[0] * (x + y) + g[1] * a + g[2] * glu + g[3] * c).to(dtype)


def _check_mixed(x, y, gammas, p: NodeMixedParams):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"node_mixed: dtype {x.dtype} not in (fp32, bf16)")
    if x.dim() != 3 or y.shape != x.shape:
        raise ValueError(f"node_mixed: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must both be (B, L, C)")
    if y.dtype != x.dtype or y.device != x.device:
        raise TypeError("node_mixed: x and y differ in dtype or device")
    B, L, C = x.shape
    if C % 8 or C > MAX_C:
        raise ValueError(f"node_mixed: C={C}, the kernel hosts multiples "
                         f"of 8 up to {MAX_C}")
    if (tuple(gammas.shape) != (4,) or gammas.dtype != torch.float32
            or gammas.device != x.device or not gammas.is_contiguous()):
        raise ValueError("node_mixed: gammas must be 4 contiguous fp32 "
                         f"values on {x.device}, got {tuple(gammas.shape)} "
                         f"{gammas.dtype} on {gammas.device}")
    want = {"ln_scale": (L, C), "ln_bias": (L, C),
            "glu_kernel": (2 * C, 2 * C), "glu_bias": (2 * C,),
            "cfc_kernel": (2 * C, C), "cfc_bias": (C,)}
    for name, shape in want.items():
        t = getattr(p, name)
        if tuple(t.shape) != shape:
            raise ValueError(f"node_mixed: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != x.dtype or t.device != x.device:
            raise TypeError(f"node_mixed: {name} is {t.dtype} on "
                            f"{t.device}, x is {x.dtype} on {x.device}")
    for name, t in [("x", x), ("y", y)] + [(n, getattr(p, n)) for n in want]:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"node_mixed: {name} must be contiguous and "
                             "16-byte aligned")


def bind_mixed(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of ``csrc/node_mixed.cu`` on a loaded
    library: every pointer and the stream as ``c_void_p``."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.node_mixed_forward.argtypes = [
        ci, vp, vp, vp, vp, ci, ci, ci, ctypes.POINTER(vp), ctypes.c_float,
        ci, ci, vp]
    lib.node_mixed_forward.restype = ci
    lib.node_mixed_smem_bytes.argtypes = [ci, ci, ci]
    lib.node_mixed_smem_bytes.restype = ctypes.c_size_t
    lib.node_mixed_geometry.argtypes = [ci, ci, ci, ci, ci, ci,
                                        ctypes.POINTER(ci)]
    lib.node_mixed_geometry.restype = ci
    lib.node_mixed_error_string.argtypes = [ci]
    lib.node_mixed_error_string.restype = ctypes.c_char_p
    return lib


def mixed_geometry(lib: ctypes.CDLL, B: int, L: int, C: int, itemsize: int,
                   samples_per_block: int = 0, cols_per_block: int = 0
                   ) -> dict:
    """The launch geometry ``node_mixed_forward`` takes for a call: samples
    and output columns a block, weight rows a K-tile, K-tiles in shared
    memory at once (all of them when the whole weight slab fits), blocks,
    blocks an SM holds, and bytes of shared memory a block. 0 lets the
    launcher pick, as the wrapper does."""
    geom = (ctypes.c_int * 7)()
    rc = lib.node_mixed_geometry(B, L, C, itemsize, samples_per_block,
                                 cols_per_block, geom)
    if rc != 0:
        raise ValueError(f"node_mixed: no geometry hosts B={B}, L={L}, "
                         f"C={C}, S={samples_per_block}, "
                         f"nt={cols_per_block}")
    return dict(zip(("samples_per_block", "cols_per_block", "k_tile",
                     "k_tiles_resident", "blocks", "blocks_per_sm",
                     "smem_bytes"), geom))


def launch_mixed(lib: ctypes.CDLL, x: torch.Tensor, y: torch.Tensor,
                 gammas: torch.Tensor, p: NodeMixedParams, eps: float,
                 stream: Optional[int], samples_per_block: int = 0,
                 cols_per_block: int = 0) -> torch.Tensor:
    """Call ``node_mixed_forward`` of a bound library on checked tensors
    and return the output; raises if the launch returns an error.
    ``samples_per_block`` (1, 2 or 4) and ``cols_per_block`` (16 or 32)
    fix the geometry; 0 lets the launcher pick from B."""
    B, L, C = x.shape
    smem = lib.node_mixed_smem_bytes(L, C, x.element_size())
    if smem > SMEM_LIMIT or L > MIXED_MAX_L:
        raise ValueError(f"node_mixed: L={L}, C={C} does not fit one block "
                         f"({smem} B of shared memory, at most "
                         f"{SMEM_LIMIT}; L at most {MIXED_MAX_L})")
    out = torch.empty_like(x)
    ptrs = (ctypes.c_void_p * 6)(*[t.data_ptr() for t in p.tensors()])
    dtype_code = 0 if x.dtype == torch.float32 else 1
    rc = lib.node_mixed_forward(
        dtype_code, x.data_ptr(), y.data_ptr(), gammas.data_ptr(),
        out.data_ptr(), B, L, C, ptrs, float(eps), samples_per_block,
        cols_per_block, stream)
    if rc != 0:
        raise RuntimeError("node_mixed kernel launch failed: "
                           + lib.node_mixed_error_string(rc).decode())
    return out


def node_mixed_op_fused(x: torch.Tensor, y: torch.Tensor,
                        gammas: torch.Tensor, p: NodeMixedParams,
                        eps: float = 1e-5) -> torch.Tensor:
    """The eval-mode mixed op: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. ``x`` and ``y`` may be the same tensor;
    ``gammas`` stays on the device (no host sync). No fallback: a CUDA call
    launches or raises. The kernel has no backward, so a CUDA call that
    would need one raises too."""
    if x.device.type == "cpu":
        return node_mixed_op_reference(x, y, gammas, p, eps)
    if x.device.type != "cuda":
        raise ValueError(f"node_mixed: no kernel for device {x.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, y, gammas] + p.tensors()):
        raise RuntimeError("node_mixed: the kernel has no backward; call it "
                           "under torch.no_grad()")
    _check_mixed(x, y, gammas, p)
    if x.shape[0] == 0:
        return torch.empty_like(x)
    from bmnas_tpu_torch.ops.kernels import _build
    with torch.cuda.device(x.device):
        out = launch_mixed(_build.load("node_mixed", bind_mixed), x, y,
                           gammas, p, eps,
                           torch.cuda.current_stream(x.device).cuda_stream)
    LAUNCHES["node_mixed"] += 1
    return out
