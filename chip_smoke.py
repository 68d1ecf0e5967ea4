#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out REPORT.json]

Run from the repository root. It imports nothing of JAX and nothing of the
JAX package. Phases, each of which fails the run (exit code != 0, no result
line) on any error:

1. device: the ``nvidia-smi`` name/power-limit line and the torch device.
2. build: every CUDA kernel of the port, from ``bmnas_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together.
3. found_cell vs plain: the found-cell kernel against its plain PyTorch
   version on the card, for seven cell configurations at L=16, C=192, B in
   {8, 37, 96}, for the four cells that phase 10 serves (two chained steps,
   multiplier 2, so the out-conv runs) at L=8, C=128, B in {2, 8, 96}, and
   for the two cells that phase 12 serves and a third (three chained steps,
   multiplier 3: an out-conv of 3C = 384 rows) at the same width and
   batches, in fp32 (tolerance 1e-4 abs + 1e-4 rel) and bf16 (2e-2 abs +
   2e-2 rel; both sides round the same fp32 result to bf16 once). Times
   (CUDA events, median, L2 flushed before each launch) at B=8, 37 and 96:
   device time (``ms``, host dispatch hidden behind a sleep kernel) and
   call time (``call_ms``, host dispatch included), for the kernel and the
   plain version, beside each configuration's bound (the larger of bytes /
   3.35 TB/s and FLOP / 67 TFLOP/s fp32, the kernel's arithmetic type) and
   its tensor-core bound (the FLOP at the dense TF32 or bf16 rate). The
   launcher picks one of two designs (``design``): the cell as phases, one
   launch each, or the whole cell in one block a sample; the design it did
   not pick is checked against the plain version too and timed
   (``alt_ms``). ``call_ms_replan``: the call time when the launcher plans
   the call anew (``found_cell_geometry`` before the call), which a call
   without the plan cache of ``csrc/found_cell.cu`` would pay, and
   ``plan_us`` that planning's host time alone. Every call is made twice on
   the same input: the two outputs must be equal bit for bit, and each
   wrapper call counts one launch whatever the cell's phases. For
   LinearGLU, ConcatFC and the four NTU cells at the timed batches: each
   phase's device time from one ``torch.profiler`` trace of a call, beside
   the geometry the launcher picked for it (the Ego cells too).
4. node_mixed vs plain: the supernet's mixed-op kernel against its plain
   version at L=16, C=192, B in {5, 8, 37, 96}, and at the NTU search
   width, L=8, C=128, B=96, fp32 and bf16 (the same tolerances), with
   softmaxed random branch weights and each of the four one-hot ones, for
   x and y two tensors and one tensor. Times as in phase 3 at B=8 and
   B=96 for the supernet's case (x is y, softmaxed weights), beside the
   bound and a second bound at the tensor cores' rate, with the launch
   geometry the launcher picked. Then, at B=37 and
   B=96, one sample a block against four samples a block (the columns a
   block as the launcher picks them for each), each checked and timed.
5. serve: a synthetic MM-IMDB test split (36 samples of 160x256 images: four
   full batches of 8 and one ragged batch of 4) and a found experiment dir
   (genotype pickle + seeded snapshot), served through the port's CLI
   ``bmnas_tpu_torch.cli.serve.main_serve`` at the full MM-IMDB width
   (C=192, L=16, steps=2, 6 input nodes, 23 genres) in fp32 and in bf16.
   The found-cell kernel must launch exactly twice per batch (one launch
   per found cell), the logits must be finite, and the weighted-F1 line
   must be printed. One batch's logits on CUDA and on the CPU must agree
   within 1e-3 (TF32 off for both matmuls and convolutions). Then a
   breakdown of one request of 8 in fp32 and bf16: host time to read the
   batch, host time of ``predict``, and each top-level layer's device-time
   span.
6. search: a synthetic MM-IMDB split of 160x256 images (46 train, 22 dev
   samples: ragged final batches of 6), one epoch of the port's bilevel
   search ``bmnas_tpu_torch.cli.mmimdb.main_search`` on the card at the
   full width (C=192, L=16, steps=2, multiplier=2, node_steps=1, batch 8),
   then the supernet's eval step over the dev split from the written
   ``best/best_model.pt``. Checks: ``log.txt``, ``metrics.jsonl`` (finite
   losses), ``best/best_genotype.pkl`` and ``architectures/epoch_0``
   written; the mixed-op kernel launched no time during the train-mode
   steps and exactly 2 x batches times in the eval step; the eval logits on
   CUDA and on the CPU within 1e-3 (TF32 off); three bilevel steps on CUDA
   and on the CPU from the same weights (64x64 images, dropout off) give
   arch tensors within rtol 5e-3 / atol 5e-6 and the same genotype. Then
   the median host time of a weight step, an arch step and an eval step at
   B=8, in three rounds, and each step's device busy time, idle share and
   kernel launches from a ``torch.profiler`` trace.
7. found: one epoch of the port's found retraining
   ``bmnas_tpu_torch.cli.mmimdb_found.main_found --search_exp_dir`` on the
   search's experiment at the same width (a correlated test split of 22
   samples, the last batch ragged at 6; the search ignores it). Checks: the
   eval dir's ``log.txt``, ``metrics.jsonl`` (train, dev and test rows,
   finite losses), ``checkpoint.pt``, ``best/best_test_model.pt`` and
   ``best/best_test_genotype.pkl``, test F1 above 0; the found-cell kernel
   launched 0 times in the train and dev phases (weight steps, train mode)
   and exactly 2 x test batches in the test phase. Then test-only
   (``--eval_exp_dir``), which must launch it exactly 2 x test batches and
   print a finite F1, and the serve CLI on the same eval dir (both F1s
   printed). Three found weight steps (every parameter) on CUDA and on the
   CPU from the same weights (64x64 images, dropout off, TF32 off) must give
   eval logits within 1e-3, the CUDA side through the kernel. Then the
   found weight step and eval step at B=8 on 160x256 images: host ms in
   three rounds, device busy ms, idle share, launches and top kernels.
8. resume: ``--resume`` on the card, for the search and for found
   retraining (on phase 6's genotype): the same seed, two epochs straight
   against one epoch and ``--resume`` for the second, on splits of 10
   samples (a full batch and a ragged one of 2) of 160x256 images at the
   full width, with cuDNN and PyTorch on deterministic algorithms
   (``CUBLAS_WORKSPACE_CONFIG=:4096:8``; the flags are restored after the
   phase). The resumed run must run the second epoch only, and the final
   parameters, BatchNorm statistics and the second epoch's losses and F1
   must agree within 1e-6. The largest differences are printed, with the
   ops that ran without a deterministic CUDA kernel; found retraining must
   run none.
9. attention vs plain: the blockwise attention kernel against its plain
   version in fp32 and bf16 inputs (rtol 2e-4 / atol 2e-5, 1e-3 for scores
   scaled by 30; both sides read the same values), output fp32, on the
   JAX kernel test's five
   shapes, B=8 x L in {16, 512, 4096} at C=192, and ragged Lq != Lk. Times
   at B=8, C=192 in fp32 (CUDA events, median, L2 flushed) of the kernel,
   the plain version and ``F.scaled_dot_product_attention(x, y, y)`` (the
   library yardstick; the port never calls it), the kernel's time over the
   library's, the geometry the launcher picked, beside the bound (the
   larger of bytes / 3.35 TB/s and FLOP / 67 TFLOP/s) and the tensor
   cores' bound (FLOP at the dense TF32 rate). At L=512 and 4096 the
   kernel is also timed under every geometry the launcher could take (its
   pick marked) and as copies with one part of the work taken
   out (``ATTN_ABLATIONS``), which say what each part costs. At B=8, L=8192,
   C=192 the call may raise ``max_memory_allocated`` by at most its output
   plus 1 MiB: the score matrix never reaches device memory. No entry point
   of the JAX package calls this kernel; this phase is its only path.
10. NTU serve: a synthetic NTU test split written by the port's
   ``make_ntu_synthetic`` (100 samples of the test subjects: uint8 clips of
   8 frames at 256x256, 40-frame skeletons; a full batch of 96 and one of
   4 samples padded to 96) and a found experiment dir (a genotype of four found
   cells of two chained inner steps, every inner op among them, node
   multiplier 2, and a seeded snapshot with He-initialised convolutions
   and randomized BatchNorm statistics), served through
   ``main_serve --task ntu`` at the NTU defaults (C=128, L=8, steps 4,
   node_steps 2, node_multiplier 2, 8 input nodes, 60 classes, the full
   inflated 3D ResNet-50 and HCN) in fp32 and in bf16. The found-cell
   kernel must launch exactly 4 times a batch, the logits must be finite,
   the accuracy line printed. The first 2 samples' logits on CUDA and on
   the CPU must agree within 1e-3 (TF32 off); on CUDA the bf16 server's
   must lie within 2x (plus 1e-3) the distance from the fp32 logits of
   those of the fp32 net run on bf16-rounded weights and input (the
   seeded net amplifies bf16's rounding; ``bf16_vs_fp32``). Then the
   breakdown of a request of 96 (median of 5) in fp32 and bf16, as in
   phase 5, with the FLOP of the backbone's convolutions and a profiler
   trace of the request (device busy ms, idle share, launches, the
   longest kernels and the op that launched each).
11. NTU search and found retraining: synthetic NTU splits written by
   ``make_ntu_synthetic`` (60 uint8 clips of 16x256x256 and 40-frame
   skeletons for each of subjects 1 and 8 (train_exp), 2 and 5 (dev), 3
   and 6 (test): every split a full batch of 96 and a ragged one). One
   epoch of the NTU search ``bmnas_tpu_torch.cli.ntu.main_search`` at the
   search defaults (C=128, L=8, steps 2, node_steps 2, node_multiplier 2,
   8 inputs, 60 classes, batch 96, the full inflated 3D ResNet-50 and
   HCN). Checks: ``log.txt`` (``Acc:`` lines, the best dev accuracy),
   ``metrics.jsonl`` (train and dev rows, ``acc``, finite),
   ``checkpoint.pt``, ``best/best_genotype.pkl`` with 2 inner steps a
   cell; the mixed-op kernel launched no time in the loop and exactly
   steps x node_steps = 4 times in the supernet's eval step on a dev batch
   of 96. Then one epoch of found retraining ``main_found
   --search_exp_dir --remat`` at the found defaults (train_val, test) on
   the search's genotype, and one on phase 10's four-cell genotype, which
   reads video inputs (a searched genotype may read skeleton inputs only,
   and then no gradient reaches the 3D ResNet): train and test rows, the
   found-cell kernel launched 0 times in train and exactly once a found
   cell and test batch in test; on the second's eval dir test-only (the
   same count) and ``main_serve --task ntu``, each printing an accuracy in
   [0, 1]. CUDA against the CPU (2
   samples at the full width, 64x64 clips, dropout off, TF32 off, from the
   same seeded weights): a search weight and arch step, then the
   supernet's eval logits; a found weight step, then its eval logits;
   each within 1e-3, the CUDA side through the kernels. ``--remat`` on the
   card: a found weight step at B=8 (8x256x256) with and without it from
   the same snapshot, batch and dropout masks, deterministic algorithms:
   parameters and BatchNorm statistics within 1e-5, the first bottleneck
   run twice with remat (the backward's rerun) and once without; the peak
   memory of
   each and the ops that ran without a deterministic CUDA kernel
   (reported, not gated). Then at B=96: the search's weight, arch and eval
   step and found retraining's weight step (``--remat``) and eval step
   (host ms in three rounds, device busy ms, idle share, launches, the
   longest kernels and the op that launched each), the peak memory of the
   found weight step, and the same step without remat (expected to run
   out of memory; reported).
12. Ego serve: the JPEG decoders found and the route that
   ``data.ego._load_jpg`` takes for a colour, a gray and a colour-encoded
   gray frame; a synthetic Ego test split written by the port's
   ``make_ego_synthetic`` (100 gestures of 32 frames of 320x240 smooth
   JPEGs, twelve to a video: a full batch of 96 and one of 4 padded to
   96) and a found experiment dir (a genotype of two found cells of three
   chained inner steps, every inner op between them, node multiplier 3,
   reading RGB and depth taps, and a seeded snapshot with He-initialised
   convolutions and BatchNorm statistics from a train-mode pass), served
   through ``main_serve --task ego`` at the Ego defaults (C=128, L=8,
   steps 2, node_steps 3, node_multiplier 3, 8 input nodes, 83 classes,
   clips cropped to 32 frames of 112x112, two full ResNeXt-101s) in fp32
   and in bf16. The found-cell kernel must launch exactly 2 times a
   batch, the logits must be finite, the accuracy line printed. The first
   2 samples' logits on CUDA and on the CPU must agree within 1e-3 (TF32
   off); the bf16 server's must pass phase 10's rule (``bf16_vs_fp32``).
   Then the breakdown of a request of 96 (median of 5) in fp32 and bf16:
   host ms to load the batch (JPEG decode, crop), ``predict`` ms, the
   spans ``rgb_net``, ``depth_net``, ``reshape_i`` and ``fusion_net``,
   the convolutions' FLOP and TFLOP/s, a profiler trace (device busy ms,
   idle share, launches, the longest kernels and the op that launched
   each) and the peak device memory.
13. result: a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, then
   ``{"ok": true, "device": {...}}`` as the last line.

Every kernel must launch on its path (found_cell: serving, the found test
phase, test-only, NTU serving, the NTU found test phase and test-only, and
Ego serving;
node_mixed: the MM-IMDB and NTU search eval steps; attention: phase 9): the
counts are set to 0 just before each path and read just after it.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import copy
import glob
import io
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
TF32_FLOP_PER_S = 495e12    # H100 SXM tensor cores, dense TF32
BF16_FLOP_PER_S = 989e12    # H100 SXM tensor cores, dense bf16
L, C = 16, 192
# (node_steps, node_multiplier, inner ops) of the kernel-vs-plain phase
CONFIGS = [
    (1, 1, ("Sum",)),
    (1, 1, ("ScaleDotAttn",)),
    (1, 1, ("LinearGLU",)),
    (1, 1, ("ConcatFC",)),
    (2, 2, ("ConcatFC", "ScaleDotAttn")),
    (2, 2, ("LinearGLU", "LinearGLU")),
    (3, 1, ("ScaleDotAttn", "Sum", "ConcatFC")),
]
TOLS = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# the NTU serving width (phase 10) and its cells' inner op pairs: two
# chained steps (the second reads the first's output), multiplier 2, so
# every call runs the out-conv
NTU_L, NTU_C = 8, 128
NTU_KERNEL_CONFIGS = [
    (2, 2, ("LinearGLU", "LinearGLU")),
    (2, 2, ("ScaleDotAttn", "ConcatFC")),
    (2, 2, ("ConcatFC", "Sum")),
    (2, 2, ("Sum", "ScaleDotAttn")),
]
# the Ego serving width (phase 12) and its cells: three chained steps,
# multiplier 3, so every call runs the out-conv over 3C = 384 rows; the
# first two are the cells that phase 12 serves (every inner op between
# them), the third puts a Sum and an attention after its GEMM step
EGO_L, EGO_C = 8, 128
EGO_KERNEL_CONFIGS = [
    (3, 3, ("ScaleDotAttn", "LinearGLU", "ConcatFC")),
    (3, 3, ("Sum", "ConcatFC", "LinearGLU")),
    (3, 3, ("LinearGLU", "Sum", "ScaleDotAttn")),
]


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: found_cell vs plain
# ---------------------------------------------------------------------------

def chain_edges(node_steps):
    return tuple(e for i in range(node_steps)
                 for e in (("skip", i), ("skip", i + 1)))


def random_params(gen, S, m, dtype, device, L=L, C=C):
    from bmnas_tpu_torch.ops.kernels.node_mixed import FoundCellParams

    def r(*shape, k=1.0):
        return (torch.randn(*shape, generator=gen) * k).to(device, dtype)
    w = 1.0 / math.sqrt(2 * C)
    return FoundCellParams(
        ln1_scale=r(S, L, C), ln1_bias=r(S, L, C),
        glu_kernel=r(S, 2 * C, 2 * C, k=w), glu_bias=r(S, 2 * C, k=0.1),
        cfc_kernel=r(S, 2 * C, C, k=w), cfc_bias=r(S, C, k=0.1),
        oc_kernel=r(m * C, C, k=1.0 / math.sqrt(m * C)) if m != 1 else None,
        oc_bias=r(C, k=0.1) if m != 1 else None,
        ln2_scale=r(L, C), ln2_bias=r(L, C))


def cell_work(B, steps_cfg, m, itemsize, L=L, C=C):
    """(bytes, FLOP) one call must move and compute: x, y and out once, each
    weight the configuration uses once; GEMMs at 2 FLOP per multiply-add,
    elementwise work at one FLOP per element and operation."""
    LC = L * C
    nbytes = 3 * B * LC + 2 * LC                      # x, y, out; ln2
    flops = B * (LC + 8 * LC)                         # residual + LN
    for branch, _, _ in steps_cfg:
        if branch == 0:
            flops += B * LC
        elif branch == 1:
            nbytes += 2 * LC
            flops += B * (4 * L * L * C + 5 * L * L + 8 * LC)
        elif branch == 2:
            nbytes += 4 * C * C + 2 * C
            flops += B * (2 * L * 2 * C * 2 * C + 6 * LC)
        else:
            nbytes += 2 * C * C + C
            flops += B * (2 * L * 2 * C * C + 2 * LC)
    if m != 1:
        nbytes += m * C * C + C
        flops += B * (2 * L * m * C * C + 2 * LC)
    return nbytes * itemsize, flops


def bound_ms(B, steps_cfg, m, itemsize, L=L, C=C):
    nbytes, flops = cell_work(B, steps_cfg, m, itemsize, L, C)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tc_bound_ms(B, steps_cfg, m, itemsize, L=L, C=C):
    """``bound_ms`` with the FLOP at the tensor cores' dense rate for the
    storage type (TF32 for fp32, bf16 for bf16): what a tensor-core
    redesign of the kernel could at best reach."""
    nbytes, flops = cell_work(B, steps_cfg, m, itemsize, L, C)
    rate = TF32_FLOP_PER_S if itemsize == 4 else BF16_FLOP_PER_S
    return max(nbytes / HBM_BYTES_PER_S, flops / rate) * 1e3


def time_ms(fn, flush, hide_host, iters=30, warmup=3):
    """Median time of one call by CUDA events, L2 flushed before each call
    (the serving path reaches the cell after the VGG stack has run through
    L2). ``hide_host``: a sleep kernel keeps the stream busy while the host
    prepares the call, so the events bracket device time only; without it
    the time is what a caller waits, host dispatch included."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(2_000_000)  # ~1 ms at 2 GHz
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# the cells whose phases phase 3 traces one by one
PHASE_TRACED = [("Sum",), ("ScaleDotAttn",), ("LinearGLU",),
                ("ConcatFC",)] + [ops for _, _, ops in NTU_KERNEL_CONFIGS
                                  + EGO_KERNEL_CONFIGS]
def kernel_times_us(fn):
    """(name, device µs) of each kernel one call of ``fn`` launches, in
    launch order, from one ``torch.profiler`` trace (after one warm call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return [(e["name"], e["dur"]) for e in sorted(
        (e for e in events if e.get("ph") == "X"
         and e.get("cat") == "kernel"), key=lambda e: e["ts"])]


def phase_rows(geometry, fn):
    """The launcher's geometry of each phase of a call beside its device
    time (``us``; None where the trace lost the kernel)."""
    times = [d for n, d in kernel_times_us(fn)
             if "found_cell_kernel" in n or "whole_cell_kernel" in n]
    if len(times) != len(geometry):
        log(f"  found_cell trace: {len(times)} kernels for "
            f"{len(geometry)} phases")
        times = [None] * len(geometry)
    return [dict(g, us=t) for g, t in zip(geometry, times)]


def kernel_phase(device):
    """The MM-IMDB width (``CONFIGS`` at L=16, C=192, B in 8/37/96), then
    the NTU and Ego serving widths (``NTU_KERNEL_CONFIGS``,
    ``EGO_KERNEL_CONFIGS`` at L=8, C=128, B in 2/8/96: 96 is phases 10 and
    12's serving batch, every batch padded to full, and 2 their
    CUDA-vs-CPU batch)."""
    gen = torch.Generator().manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    rows = []
    for node_steps, m, ops in CONFIGS:
        rows += cell_cases(gen, flush, device, node_steps, m, ops, L, C,
                           (8, 37, 96))
    for node_steps, m, ops in NTU_KERNEL_CONFIGS:
        rows += cell_cases(gen, flush, device, node_steps, m, ops, NTU_L,
                           NTU_C, (2, 8, 96))
    for node_steps, m, ops in EGO_KERNEL_CONFIGS:
        rows += cell_cases(gen, flush, device, node_steps, m, ops, EGO_L,
                           EGO_C, (2, 8, 96))
    return rows


def plan_us(lib, B, Ll, Cc, cfg, m, itemsize, n=200):
    """Host µs of the launcher's plan of a call made anew (the C function
    ``found_cell_geometry``, called through ctypes), mean of n."""
    import ctypes
    from bmnas_tpu_torch.ops.kernels.node_mixed import _steps_arrays
    arrays = _steps_arrays(cfg)
    geom, count = (ctypes.c_int * 128)(), ctypes.c_int(0)
    t0 = time.perf_counter()
    for _ in range(n):
        rc = lib.found_cell_geometry(B, Ll, Cc, len(cfg), m, *arrays,
                                     itemsize, 0, 0, 0, geom,
                                     ctypes.byref(count))
    if rc != 0:
        raise AssertionError(f"found_cell_geometry returned {rc}")
    return (time.perf_counter() - t0) / n * 1e6


def within(got, want, tol):
    """(max abs error, all finite and within tol abs + tol rel)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    return float(err.max()), bool(torch.isfinite(g).all()) and bool(
        (err <= tol + tol * w.abs()).all())


def cell_cases(gen, flush, device, node_steps, m, ops, Ll, Cc, batches):
    """One cell configuration against its plain version in fp32 and bf16 at
    each B of ``batches``, in both designs, timed at B=8, 37 and 96."""
    from bmnas_tpu_torch.ops.kernels import LAUNCHES, _build
    from bmnas_tpu_torch.ops.kernels.node_mixed import (
        bind,
        found_cell_geometry,
        found_cell_scratch_numel,
        found_cell_steps_cfg,
        found_node_cell_fused,
        found_node_cell_reference,
        launch,
    )
    rows = []
    lib = _build.load("found_cell", bind)
    stream = torch.cuda.current_stream(device).cuda_stream
    cfg = found_cell_steps_cfg(chain_edges(node_steps), ops)
    for dtype in (torch.float32, torch.bfloat16):
        p = random_params(gen, node_steps, m, dtype, device, Ll, Cc)
        for B in batches:
            x = torch.randn(B, Ll, Cc, generator=gen).to(device, dtype)
            y = torch.randn(B, Ll, Cc, generator=gen).to(device, dtype)
            before = LAUNCHES["found_cell"]
            got = found_node_cell_fused(x, y, p, cfg, m)
            torch.cuda.synchronize()
            launched = LAUNCHES["found_cell"] - before
            repeat = torch.equal(got, found_node_cell_fused(x, y, p, cfg, m))
            want = found_node_cell_reference(x, y, p, cfg, m)
            tol = TOLS[dtype]
            err, ok = within(got, want, tol)
            geometry = found_cell_geometry(lib, B, Ll, Cc, cfg, m,
                                           x.element_size())
            design = ("whole" if [g["kind"] for g in geometry] == ["whole"]
                      else "phases")
            alt = "phases" if design == "whole" else "whole"
            scratch = torch.empty(
                found_cell_scratch_numel(B, Ll, Cc, node_steps),
                device=device)
            tickets = torch.zeros(B, dtype=torch.int32, device=device)
            alt_fn = lambda: launch(  # noqa: E731
                lib, x, y, p, cfg, m, 1e-5, stream, scratch, 0, 0, tickets,
                design=alt)
            alt_err, alt_ok = within(alt_fn(), want, tol)
            row = {"ops": "+".join(ops), "node_steps": node_steps,
                   "m": m, "L": Ll, "C": Cc, "B": B,
                   "dtype": str(dtype).split(".")[-1],
                   "launches": launched, "phases": len(geometry),
                   "design": design, "bitwise_repeat": repeat,
                   "max_abs_err": err, "tolerance": tol, "ok": ok,
                   "alt_design": alt, "alt_max_abs_err": alt_err,
                   "alt_ok": alt_ok}
            if B in (8, 37, 96):
                kern = lambda: found_node_cell_fused(  # noqa: E731
                    x, y, p, cfg, m)
                plain = lambda: found_node_cell_reference(  # noqa: E731
                    x, y, p, cfg, m)
                itemsize = x.element_size()

                def replan():
                    plan_us(lib, B, Ll, Cc, cfg, m, itemsize, n=1)
                    return kern()
                row["ms"] = time_ms(kern, flush, True)
                row["alt_ms"] = time_ms(alt_fn, flush, True)
                row["plain_ms"] = time_ms(plain, flush, True)
                row["call_ms"] = time_ms(kern, flush, False)
                row["call_ms_replan"] = time_ms(replan, flush, False)
                row["plan_us"] = plan_us(lib, B, Ll, Cc, cfg, m, itemsize)
                row["plain_call_ms"] = time_ms(plain, flush, False)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    B, cfg, m, x.element_size(), Ll, Cc)
                row["tc_bound_ms"] = tc_bound_ms(
                    B, cfg, m, x.element_size(), Ll, Cc)
                if ops in PHASE_TRACED:
                    row["phase_times"] = phase_rows(geometry, kern)
            rows.append(row)
            log("  found_cell {ops:<30} L={L:<2} C={C:<3} B={B:<3} "
                "{dtype:<8} max_abs_err={max_abs_err:.3g} ok={ok} "
                "design={design} phases={phases} "
                "bitwise_repeat={bitwise_repeat} {alt_design}: "
                "max_abs_err={alt_max_abs_err:.3g} ok={alt_ok}".format(**row)
                + ("  ms={ms:.4f} alt_ms={alt_ms:.4f} plain_ms={plain_ms:.4f}"
                   " bound_ms={bound_ms:.5f} tc_bound_ms={tc_bound_ms:.5f} "
                   "call_ms={call_ms:.4f} "
                   "call_ms_replan={call_ms_replan:.4f} "
                   "plan_us={plan_us:.2f} "
                   "plain_call_ms={plain_call_ms:.4f}".format(**row)
                   if "ms" in row else ""))
            for ph in row.get("phase_times", []):
                log("    phase {kind:<8} step={step:<2} S={samples_per_block} "
                    "nt={cols_per_block:<3} kt={k_tile:<2} "
                    "resident={k_tiles_resident:<2} blocks={blocks:<4} "
                    "threads={threads} per_sm={blocks_per_sm} "
                    "smem={smem_bytes} us={us}".format(**ph))
            if not ok or not alt_ok or launched != 1 or not repeat:
                raise AssertionError(f"found_cell disagrees with its "
                                     f"plain version, or with itself: {row}")
    return rows


# ---------------------------------------------------------------------------
# phase 4: node_mixed vs plain
# ---------------------------------------------------------------------------

MIXED_GAMMAS = ("softmax", "sum", "attn", "glu", "fc")


def mixed_params(gen, dtype, device, L=L, C=C):
    from bmnas_tpu_torch.ops.kernels.node_mixed import NodeMixedParams

    def r(*shape, k=1.0):
        return (torch.randn(*shape, generator=gen) * k).to(device, dtype)
    w = 1.0 / math.sqrt(2 * C)
    return NodeMixedParams(
        ln_scale=r(L, C), ln_bias=r(L, C),
        glu_kernel=r(2 * C, 2 * C, k=w), glu_bias=r(2 * C, k=0.1),
        cfc_kernel=r(2 * C, C, k=w), cfc_bias=r(C, k=0.1))


def mixed_work(B, itemsize, same, L=L, C=C):
    """(bytes, FLOP) of one mixed-op call: x (and y unless it is x), out,
    the LayerNorm affine and both dense layers once, the four fp32 branch
    weights; GEMMs at 2 FLOP per multiply-add, elementwise work at one FLOP
    per element and operation."""
    LC = L * C
    nbytes = ((2 if same else 3) * B * LC + 2 * LC + 6 * C * C + 3 * C) \
        * itemsize + 4 * 4
    flops = B * (LC                                    # x + y
                 + 4 * L * L * C + 5 * L * L + 8 * LC  # attention + LN
                 + 2 * L * 2 * C * 2 * C + 6 * LC      # GLU
                 + 2 * L * 2 * C * C + 2 * LC          # ConcatFC + ReLU
                 + 7 * LC)                             # the weighted sum
    return nbytes, flops


def mixed_bound_ms(B, itemsize, same, L=L, C=C):
    nbytes, flops = mixed_work(B, itemsize, same, L, C)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def mixed_tc_bound_ms(B, itemsize, same, L=L, C=C):
    """A second bound beside ``mixed_bound_ms``: the same bytes and FLOP,
    the FLOP at the tensor cores' dense rate for the storage type (TF32
    for fp32, bf16 for bf16). The kernel runs 3xTF32, three TF32 products
    for each fp32 one, so for fp32 this bound is not reachable."""
    nbytes, flops = mixed_work(B, itemsize, same, L, C)
    rate = TF32_FLOP_PER_S if itemsize == 4 else BF16_FLOP_PER_S
    return max(nbytes / HBM_BYTES_PER_S, flops / rate) * 1e3


# B of phase 4; B=5 is smaller than any grid the launcher could fill
MIXED_BATCHES = (5, 8, 37, 96)
# (B, label, samples a block): one sample a block against four, the columns
# a block and the K-tiles as the launcher picks them for that S, on the
# supernet's call (x is y, softmaxed gammas)
MIXED_PAIRS = [(B, label, S) for B in (37, 96)
               for label, S in (("one sample a block", 1),
                                ("four samples a block", 4))]


def mixed_phase(device):
    """The MM-IMDB width (L=16, C=192, ``MIXED_BATCHES``), then the NTU
    search width (L=8, C=128) at its batch of 96, then
    ``mixed_pairs``."""
    from bmnas_tpu_torch.ops.kernels import _build
    from bmnas_tpu_torch.ops.kernels.node_mixed import bind_mixed
    lib = _build.load("node_mixed", bind_mixed)
    gen = torch.Generator().manual_seed(1)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    rows = (mixed_cases(lib, gen, flush, device, L, C, MIXED_BATCHES)
            + mixed_cases(lib, gen, flush, device, NTU_L, NTU_C,
                          (NTU_BATCH,)))
    for dt in ("float32", "bfloat16"):
        log("  node_mixed {}: {} checks ok, max_abs_err {:.3g}".format(
            dt, sum(r["dtype"] == dt for r in rows),
            max(r["max_abs_err"] for r in rows if r["dtype"] == dt)))
    return rows, mixed_pairs(lib, device, gen, flush)


def mixed_cases(lib, gen, flush, device, L, C, batches):
    """Each of ``MIXED_GAMMAS``, x and y two tensors and one, at each of
    ``batches``, in fp32 and bf16, against the plain version; the
    supernet's call (x is y, softmaxed gammas) timed at B=8 and B=96."""
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    from bmnas_tpu_torch.ops.kernels.node_mixed import (
        mixed_geometry,
        node_mixed_op_fused,
        node_mixed_op_reference,
    )
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        p = mixed_params(gen, dtype, device, L, C)
        for B in batches:
            x = torch.randn(B, L, C, generator=gen).to(device, dtype)
            y = torch.randn(B, L, C, generator=gen).to(device, dtype)
            geom = mixed_geometry(lib, B, L, C, x.element_size())
            for gk in MIXED_GAMMAS:
                g = (torch.randn(4, generator=gen).softmax(0)
                     if gk == "softmax" else torch.eye(4)[
                         MIXED_GAMMAS.index(gk) - 1]).to(device)
                for same in (False, True):
                    yy = x if same else y
                    before = LAUNCHES["node_mixed"]
                    got = node_mixed_op_fused(x, yy, g, p)
                    torch.cuda.synchronize()
                    launched = LAUNCHES["node_mixed"] - before
                    want = node_mixed_op_reference(x, yy, g, p)
                    gf, wf = got.float(), want.float()
                    err = (gf - wf).abs()
                    tol = TOLS[dtype]
                    ok = bool(torch.isfinite(gf).all()) and bool(
                        (err <= tol + tol * wf.abs()).all())
                    row = {"gammas": gk, "x_is_y": same, "B": B, "L": L,
                           "C": C, "dtype": str(dtype).split(".")[-1],
                           "geometry": geom, "launches": launched,
                           "max_abs_err": float(err.max()),
                           "tolerance": tol, "ok": ok}
                    if B in (8, 96) and gk == "softmax" and same:
                        kern = lambda: node_mixed_op_fused(  # noqa: E731
                            x, x, g, p)
                        plain = lambda: node_mixed_op_reference(  # noqa
                            x, x, g, p)
                        row["ms"] = time_ms(kern, flush, True)
                        row["plain_ms"] = time_ms(plain, flush, True)
                        row["call_ms"] = time_ms(kern, flush, False)
                        row["plain_call_ms"] = time_ms(plain, flush, False)
                        row["bound_ms"], row["bound_by"] = mixed_bound_ms(
                            B, x.element_size(), True, L, C)
                        row["tc_bound_ms"] = mixed_tc_bound_ms(
                            B, x.element_size(), True, L, C)
                    rows.append(row)
                    if not ok or launched != 1:
                        raise AssertionError(f"node_mixed disagrees with "
                                             f"its plain version: {row}")
                    if "ms" in row:
                        log("  node_mixed L={L} C={C} B={B:<3} {dtype:<8} "
                            "x is y, "
                            "softmaxed gammas: ms={ms:.4f} "
                            "plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f}"
                            " ({bound_by}) tc_bound_ms={tc_bound_ms:.5f} "
                            "call_ms={call_ms:.4f} "
                            "plain_call_ms={plain_call_ms:.4f} "
                            "geometry={geometry}".format(**row))
    return rows


def mixed_pairs(lib, device, gen, flush):
    """``MIXED_PAIRS``: each geometry against the plain version (the same
    tolerances) and timed, in fp32 and bf16. These launches go straight to
    the library and are not counted."""
    from bmnas_tpu_torch.ops.kernels.node_mixed import (
        launch_mixed,
        mixed_geometry,
        node_mixed_op_reference,
    )
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        p = mixed_params(gen, dtype, device)
        g = torch.randn(4, generator=gen).softmax(0).to(device)
        for B, label, S in MIXED_PAIRS:
            x = torch.randn(B, L, C, generator=gen).to(device, dtype)
            stream = torch.cuda.current_stream(device).cuda_stream

            def kern():
                return launch_mixed(lib, x, x, g, p, 1e-5, stream, S)
            got = kern().float()
            want = node_mixed_op_reference(x, x, g, p).float()
            err = (got - want).abs()
            tol = TOLS[dtype]
            row = {"B": B, "dtype": str(dtype).split(".")[-1],
                   "label": label,
                   "geometry": mixed_geometry(lib, B, L, C,
                                              x.element_size(), S),
                   "max_abs_err": float(err.max()), "tolerance": tol,
                   "ok": bool(torch.isfinite(got).all())
                   and bool((err <= tol + tol * want.abs()).all()),
                   "ms": time_ms(kern, flush, True)}
            out.append(row)
            log("  node_mixed B={B:<3} {dtype:<8} {label}: ms={ms:.4f} "
                "max_abs_err={max_abs_err:.3g} ok={ok} "
                "geometry={geometry}".format(**row))
            if not row["ok"]:
                raise AssertionError(f"node_mixed ({label}) disagrees with "
                                     f"its plain version: {row}")
    return out


# ---------------------------------------------------------------------------
# phase 5: serve
# ---------------------------------------------------------------------------

SERVE_CFG = dict(C=C, L=L, steps=2, multiplier=2, node_steps=1,
                 node_multiplier=1, num_input_nodes=6, num_keep_edges=2,
                 num_outputs=23, drpt=0.1)
SERVE_SAMPLES, BATCH = 36, 8


def serve_genotype():
    from bmnas_tpu_torch.genotype import Genotype, StepGenotype
    return Genotype(
        edges=[("skip", 0), ("skip", 4), ("skip", 2), ("skip", 5)],
        concat=[6, 7],
        steps=[StepGenotype([("skip", 0), ("skip", 1)], ["ScaleDotAttn"],
                            [2]),
               StepGenotype([("skip", 1), ("skip", 0)], ["LinearGLU"], [2])])


def write_experiment(root):
    """Synthetic test split + found experiment dir with a seeded snapshot."""
    from bmnas_tpu_torch.data.synthetic import make_mmimdb_synthetic
    from bmnas_tpu_torch.genotype import save_genotype
    from bmnas_tpu_torch.utils.checkpoint import save_model

    data = os.path.join(root, "data")
    make_mmimdb_synthetic(data, image_hw=(160, 256), seed=0,
                          counts={"train": 0, "dev": 0,
                                  "test": SERVE_SAMPLES})
    best = os.path.join(root, "exp", "best")
    os.makedirs(best)
    geno = serve_genotype()
    save_genotype(geno, os.path.join(best, "best_genotype.pkl"))
    save_model(os.path.join(best, "best_model.pt"), seeded_found_net(0))
    return data, os.path.join(root, "exp")


def seeded_found_net(seed):
    """The served genotype's found net at the full width on the CPU, VGG
    convolutions He-initialised (activations stay O(1)), BatchNorm
    statistics and affines randomized (folding is exercised)."""
    from bmnas_tpu_torch.models.mmimdb import FoundImageTextNet
    torch.manual_seed(seed)
    model = FoundImageTextNet.from_genotype(serve_genotype(), device="cpu",
                                            **SERVE_CFG)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv2d):
                mod.weight.normal_(0.0, math.sqrt(2.0 / (9 * mod.in_channels)),
                                   generator=gen)
                mod.bias.zero_()
            if isinstance(mod, torch.nn.BatchNorm1d):
                mod.running_mean.normal_(0.0, 0.1, generator=gen)
                mod.running_var.uniform_(0.5, 1.5, generator=gen)
                mod.weight.uniform_(0.5, 1.5, generator=gen)
                mod.bias.normal_(0.0, 0.1, generator=gen)
    return model


def serve_once(data, exp, bf16):
    from bmnas_tpu_torch.cli.serve import main_serve
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    argv = ["--task", "mmimdb", "--eval_exp_dir", exp, "--datadir", data,
            "--batchsize", str(BATCH), "--num_workers", "4"] + (
                ["--bf16"] if bf16 else [])
    before = LAUNCHES["found_cell"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main_serve(argv)
    printed = buf.getvalue()
    sys.stdout.write(printed)
    launched = LAUNCHES["found_cell"] - before
    line = json.loads(printed.strip().splitlines()[-1])
    if line != result or line["metric"] != "weighted_f1":
        raise AssertionError(f"serve printed {line!r}, returned {result!r}")
    n_batches = -(-SERVE_SAMPLES // BATCH)
    checks = {
        "samples": result["samples"] == SERVE_SAMPLES,
        "batches": result["batches"] == n_batches,
        "launches == 2 x batches": launched == 2 * result["batches"],
        "finite logits": result["logits_finite"],
        "samples_per_sec": result["samples_per_sec"] > 0,
        "f1 in [0, 1]": 0.0 <= result["value"] <= 1.0,
    }
    if not all(checks.values()):
        raise AssertionError(f"serve (bf16={bf16}) failed {checks}: "
                             f"{result}, launches={launched}")
    return dict(result, launches=launched)


def serve_eval_dir(eval_dir, data):
    """The serve CLI on a found eval dir (``best_test_*``), fp32."""
    from bmnas_tpu_torch.cli.serve import main_serve
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    before = LAUNCHES["found_cell"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main_serve(["--task", "mmimdb", "--eval_exp_dir", eval_dir,
                             "--datadir", data, "--batchsize", str(BATCH),
                             "--num_workers", "4"])
    sys.stdout.write(buf.getvalue())
    launched = LAUNCHES["found_cell"] - before
    if not (result["model"].endswith("best_test_model.pt")
            and launched == 2 * result["batches"]
            and result["logits_finite"]):
        raise AssertionError(f"serve on the eval dir: {result}, "
                             f"launches={launched}")
    return dict(result, launches=launched)


def cuda_vs_cpu(data, exp):
    """One batch's logits: the port on CUDA against the port on the CPU."""
    from bmnas_tpu_torch.data.mmimdb import MMIMDBDataset
    from bmnas_tpu_torch.genotype import load_genotype
    from bmnas_tpu_torch.models.mmimdb import FoundImageTextNet
    from bmnas_tpu_torch.serving import load_server
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    geno = load_genotype(os.path.join(exp, "best", "best_genotype.pkl"))
    snap = os.path.join(exp, "best", "best_model.pt")
    batch = next(iter(MMIMDBDataset(data, "test", num_workers=4)
                      .batches(BATCH, shuffle=False)))
    out = {}
    for dev in ("cuda", "cpu"):
        model = FoundImageTextNet.from_genotype(geno, device=dev,
                                                **SERVE_CFG)
        out[dev] = load_server(snap, model, device=dev).predict(batch)
    diff = float(np.abs(out["cuda"] - out["cpu"]).max())
    if not (np.isfinite(out["cuda"]).all() and diff <= 1e-3):
        raise AssertionError(f"CUDA vs CPU logits differ by {diff}")
    return {"max_abs_diff": diff, "logits_abs_max":
            float(np.abs(out["cpu"]).max()), "tolerance": 1e-3}


def serve_breakdown(data, exp, dtype, iters=20):
    """Where one request's time goes (``request_breakdown``), MM-IMDB."""
    from bmnas_tpu_torch.data.mmimdb import MMIMDBDataset
    from bmnas_tpu_torch.genotype import load_genotype
    from bmnas_tpu_torch.models.mmimdb import FoundImageTextNet
    from bmnas_tpu_torch.serving import load_server
    geno = load_genotype(os.path.join(exp, "best", "best_genotype.pkl"))
    model = FoundImageTextNet.from_genotype(geno, device="cuda", **SERVE_CFG)
    server = load_server(os.path.join(exp, "best", "best_model.pt"), model,
                         dtype=dtype, device="cuda")
    dataset = MMIMDBDataset(data, "test", num_workers=4)
    parts = (["imagenet", "textnet"] + [f"reshape_{i}" for i in model.used]
             + ["fusion_net", "central_classifier"])
    return request_breakdown(server, dataset, BATCH, parts, iters)


def request_breakdown(server, dataset, batch, parts, iters):
    """Where one request's time goes: the host time to read one batch from
    disk (the mean over the split), the host time of
    ``FoundNetServer.predict`` on its first batch (upload, forward, logits
    back) and the device-time span of each of ``parts`` (top-level layers;
    CUDA events in forward hooks), medians over ``iters`` after 3 warm-up
    requests."""
    t0 = time.perf_counter()
    batches = list(dataset.batches(batch, shuffle=False))
    load_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    spans = {n: [] for n in parts}

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e
    hooks = []
    for n in parts:
        mod = server.model.get_submodule(n)
        hooks.append(mod.register_forward_pre_hook(
            lambda m, a, n=n: spans[n].append([event()])))
        hooks.append(mod.register_forward_hook(
            lambda m, a, o, n=n: spans[n][-1].append(event())))
    request_ms = []
    for _ in range(iters + 3):
        t = time.perf_counter()
        server.predict(batches[0])
        request_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    layer_ms = {n: statistics.median(a.elapsed_time(b) for a, b in s[3:])
                for n, s in spans.items()}
    request = statistics.median(request_ms[3:])
    return {"dtype": str(server.dtype).split(".")[-1], "batch": batch,
            "load_ms_per_batch": load_ms, "predict_ms": request,
            "predict_ms_all": request_ms[3:],
            "layer_device_ms": layer_ms,
            "other_ms": request - sum(layer_ms.values())}


# ---------------------------------------------------------------------------
# phase 6: search
# ---------------------------------------------------------------------------

SEARCH_CFG = dict(SERVE_CFG)
# the search reads train and dev; found retraining and test-only also test
SEARCH_COUNTS = {"train": 46, "dev": 22, "test": 22}


def search_run(root):
    """One epoch of ``main_search`` on the card; returns (exp dir, data dir,
    node_mixed launches during the run)."""
    from bmnas_tpu_torch.cli.mmimdb import main_search
    from bmnas_tpu_torch.data.synthetic import make_mmimdb_synthetic
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    data = os.path.join(root, "search_data")
    # labels that follow the text (a learnable rule, about half positive):
    # after one epoch the dev F1 is above 0, so a best snapshot is written
    make_mmimdb_synthetic(data, image_hw=(160, 256), seed=2,
                          correlated=True, counts=SEARCH_COUNTS)
    cwd = os.getcwd()
    os.chdir(root)  # main_search writes final_exp/ under the working dir
    try:
        before = LAUNCHES["node_mixed"]
        t0 = time.perf_counter()
        best_f1, geno = main_search([
            "--datadir", data, "--epochs", "1", "--batchsize", str(BATCH),
            "--num_workers", "4"])
        seconds = time.perf_counter() - t0
        launched = LAUNCHES["node_mixed"] - before
    finally:
        os.chdir(cwd)
    (exp,) = glob.glob(os.path.join(root, "final_exp", "mmimdb",
                                    "search-EXP-*"))
    return exp, data, launched, best_f1, geno, seconds


def check_search_artifacts(exp, best_f1, geno):
    from bmnas_tpu_torch.genotype import load_genotype
    with open(os.path.join(exp, "log.txt")) as f:
        log_text = f.read()
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(r) for r in f]
    pkl = os.path.join(exp, "best", "best_genotype.pkl")
    checks = {
        "log.txt train/dev lines": "train Loss:" in log_text
        and "dev Loss:" in log_text,
        "metrics.jsonl train+dev, finite": [r["phase"] for r in rows]
        == ["train", "dev"] and all(math.isfinite(r["loss"]) for r in rows),
        "best_genotype.pkl": os.path.exists(pkl)
        and load_genotype(pkl) == geno,
        "best_model.pt": os.path.exists(os.path.join(exp, "best",
                                                     "best_model.pt")),
        "architectures/epoch_0": bool(glob.glob(os.path.join(
            exp, "architectures", "epoch_0*"))),
        "f1 in (0, 1]": 0.0 < best_f1 <= 1.0,
    }
    if not all(checks.values()):
        raise AssertionError(f"search artifacts: {checks}")
    return {"metrics": rows, "best_f1": best_f1, "genotype": str(geno)}


def search_model(exp, device):
    """The searched supernet and its arch tensors from best_model.pt."""
    from bmnas_tpu_torch.models.mmimdb import SearchableImageTextNet
    from bmnas_tpu_torch.utils.checkpoint import load_checkpoint
    sd, arch = load_checkpoint(os.path.join(exp, "best", "best_model.pt"))
    model = SearchableImageTextNet(**SEARCH_CFG)
    model.load_state_dict(sd)
    return model.to(device), {k: v.to(device) for k, v in arch.items()}


def search_eval(exp, data, device):
    """The supernet's eval step over the dev split."""
    from bmnas_tpu_torch.cli.mmimdb import batches_on, counts_fn
    from bmnas_tpu_torch.data.mmimdb import MMIMDBDataset
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    from bmnas_tpu_torch.search.bilevel import (
        TrainState,
        bce_with_logits,
        build_step_functions,
    )
    from bmnas_tpu_torch.utils.metrics import f1_from_counts
    model, arch = search_model(exp, device)
    state = TrainState(model=model, arch=arch, opt_w=None, opt_arch=None)
    fns = build_step_functions(bce_with_logits, counts_fn)
    dev = MMIMDBDataset(data, "dev", num_workers=4)
    before = LAUNCHES["node_mixed"]
    total, n = None, 0
    for b in batches_on(device, dev.batches(BATCH, shuffle=False)):
        c = fns.eval_step(state, b)
        total = c if total is None else {k: total[k] + c[k] for k in total}
        n += 1
    torch.cuda.synchronize()
    launched = LAUNCHES["node_mixed"] - before
    loss = float(total["loss_sum"]) / len(dev)
    f1 = f1_from_counts(total, "weighted")
    if not (launched == 2 * n and math.isfinite(loss) and 0 <= f1 <= 1):
        raise AssertionError(f"search eval step: {n} batches, {launched} "
                             f"node_mixed launches, loss {loss}, f1 {f1}")
    return {"batches": n, "launches": launched, "loss": loss, "f1": f1}


def search_cuda_vs_cpu(exp, data, devices=("cuda", "cpu")):
    """One dev batch's eval logits, the port on CUDA against the CPU."""
    from bmnas_tpu_torch.cli.mmimdb import batches_on
    from bmnas_tpu_torch.data.mmimdb import MMIMDBDataset
    batch = next(iter(MMIMDBDataset(data, "dev", num_workers=4)
                      .batches(BATCH, shuffle=False)))
    out = []
    for dev in devices:
        model, arch = search_model(exp, dev)
        with torch.no_grad():
            b = next(batches_on(torch.device(dev), [batch]))
            out.append(model.eval()(b, arch).float().cpu().numpy())
    diff = float(np.abs(out[0] - out[1]).max())
    if not (np.isfinite(out[0]).all() and diff <= 1e-3):
        raise AssertionError(f"search eval logits: CUDA vs CPU differ by "
                             f"{diff}")
    return {"max_abs_diff": diff, "logits_abs_max":
            float(np.abs(out[1]).max()), "tolerance": 1e-3}


def _step_setup(model, arch, device):
    from bmnas_tpu_torch.models.mmimdb import MMIMDB_FROZEN_PREFIXES
    from bmnas_tpu_torch.search.bilevel import (
        TrainState,
        freeze,
        make_arch_optimizer,
        make_weight_optimizer,
    )
    model = copy.deepcopy(model).to(device)
    freeze(model, MMIMDB_FROZEN_PREFIXES)
    arch = {k: v.detach().clone().to(device).requires_grad_()
            for k, v in arch.items()}
    return TrainState(
        model=model, arch=arch,
        opt_w=make_weight_optimizer(model, MMIMDB_FROZEN_PREFIXES, 1e-4),
        opt_arch=make_arch_optimizer(arch, 3e-4, 1e-3))


def _synthetic_batch(rng, hw, valid=BATCH):
    b = {"image": rng.randn(BATCH, *hw, 3).astype(np.float32),
         "text": rng.randn(BATCH, 300).astype(np.float32),
         "label": (rng.rand(BATCH, 23) < 0.2).astype(np.float32),
         "mask": (np.arange(BATCH) < valid).astype(np.float32)}
    for k in ("image", "text", "label"):
        b[k][valid:] = 0.0
    return b


def search_steps_cuda_vs_cpu(devices=("cuda", "cpu")):
    """Three bilevel steps from the same seeded weights on CUDA and on the
    CPU, 64x64 images, dropout off."""
    from bmnas_tpu_torch.cli.mmimdb import batches_on, counts_fn
    from bmnas_tpu_torch.models.mmimdb import SearchableImageTextNet
    from bmnas_tpu_torch.models.supernet import (
        derive_genotype_from_arch,
        init_arch_params,
    )
    from bmnas_tpu_torch.search.bilevel import (
        bce_with_logits,
        build_step_functions,
    )
    torch.manual_seed(3)
    model = SearchableImageTextNet(**SEARCH_CFG)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    arch = init_arch_params(torch.Generator().manual_seed(4), 2, 6, 1)
    rng = np.random.RandomState(5)
    train_b = _synthetic_batch(rng, (64, 64), valid=BATCH - 2)
    dev_b = _synthetic_batch(rng, (64, 64))
    fns = build_step_functions(bce_with_logits, counts_fn)
    got = []
    for dev in devices:
        state = _step_setup(model, arch, dev)
        tb, db = batches_on(torch.device(dev), [train_b, dev_b])
        for eta in (1e-3, 9e-4, 8e-4):
            fns.weight_step(state, tb, eta)
            fns.arch_step(state, db)
        got.append(({k: v.detach().cpu() for k, v in state.arch.items()},
                    derive_genotype_from_arch(state.arch, 2, 2, 6, 1, 1)))
    (a_gpu, g_gpu), (a_cpu, g_cpu) = got
    close = all(torch.allclose(a_gpu[k], a_cpu[k], rtol=5e-3, atol=5e-6)
                for k in a_cpu)
    diff = max(float((a_gpu[k] - a_cpu[k]).abs().max()) for k in a_cpu)
    moved = max(float((a_cpu[k] - arch[k].detach()).abs().max())
                for k in a_cpu)
    if not (close and g_gpu == g_cpu):
        raise AssertionError(f"bilevel steps CUDA vs CPU: arch max diff "
                             f"{diff}, genotypes {g_gpu} / {g_cpu}")
    return {"arch_max_abs_diff": diff, "arch_moved": moved,
            "rtol": 5e-3, "atol": 5e-6, "same_genotype": True}


def device_busy_ms(fn, tmp, iters=5, top=3):
    """Device busy time of one call of ``fn``, its number of kernel
    launches and its ``top`` longest kernels, from a ``torch.profiler`` trace
    of ``iters`` calls: the union of the kernel, memcpy and memset
    intervals, over ``iters``. Each of the longest kernels comes as (name,
    ms a call, the innermost PyTorch op whose host span holds the launch).
    None when the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    path = os.path.join(tmp, "step_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in
                   ("kernel", "gpu_memcpy", "gpu_memset"))
    if not spans:
        return None, 0.0, []
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name, launches = {}, 0
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
            launches += 1
    longest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    ops = launching_ops(events, {n for n, _ in longest})
    return (busy / iters / 1e3, launches / iters,
            [(n[:80], d / iters / 1e3, ops.get(n)) for n, d in longest])


def launching_ops(events, names):
    """For each kernel name in ``names``, the innermost ``cpu_op`` of the
    trace whose span on the host thread holds the runtime or driver call
    that launched the kernel (joined by the trace's correlation id); the
    most frequent one where launches differ."""
    launch_at = {e["args"]["correlation"]: (e["tid"], e["ts"])
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    by_tid = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "cpu_op":
            by_tid.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["name"]))
    for spans in by_tid.values():
        spans.sort()
    starts = {tid: [a for a, _, _ in spans] for tid, spans in by_tid.items()}
    votes = {}
    for e in events:
        if not (e.get("ph") == "X" and e.get("cat") == "kernel"
                and e["name"] in names):
            continue
        at = launch_at.get(e.get("args", {}).get("correlation"))
        if at is None or at[0] not in by_tid:
            continue
        tid, ts = at
        spans = by_tid[tid]
        # ops nest, so the latest-starting op that still holds ``ts`` is
        # the innermost
        op = None
        for i in range(bisect.bisect_right(starts[tid], ts) - 1, -1, -1):
            if spans[i][1] >= ts:
                op = spans[i][2]
                break
        count = votes.setdefault(e["name"], {})
        count[op] = count.get(op, 0) + 1
    return {n: max(c, key=c.get) for n, c in votes.items()}


def first_batch(data, split, device):
    from bmnas_tpu_torch.cli.mmimdb import batches_on
    from bmnas_tpu_torch.data.mmimdb import MMIMDBDataset
    (b,) = batches_on(device, [next(iter(MMIMDBDataset(
        data, split, num_workers=4).batches(BATCH, shuffle=False)))])
    return b


def search_step_times(exp, data, device, tmp):
    """The search's weight, arch and eval step at B=8 on a dev batch of
    160x256 images (``step_times``)."""
    from bmnas_tpu_torch.cli.mmimdb import counts_fn
    from bmnas_tpu_torch.search.bilevel import (
        bce_with_logits,
        build_step_functions,
    )
    model, arch = search_model(exp, "cpu")
    state = _step_setup(model, arch, device)
    fns = build_step_functions(bce_with_logits, counts_fn)
    b = first_batch(data, "dev", device)
    return step_times({"weight_step": lambda: fns.weight_step(state, b, 1e-3),
                       "arch_step": lambda: fns.arch_step(state, b),
                       "eval_step": lambda: fns.eval_step(state, b)}, tmp)


def step_times(steps, tmp, iters=10, rounds=3, trace_iters=5, top=3):
    """Host time of each step (it ends in a synchronize): the median of
    ``iters`` steps, in ``rounds`` rounds that take turns over the steps.
    Then each step's device busy time, kernel launches and ``top`` longest
    kernels from a profiler trace of ``trace_iters`` steps, and the
    device's idle share of the last round's median."""
    out = {name: {"host_ms_rounds": []} for name in steps}
    for _ in range(rounds):
        for name, fn in steps.items():
            times = []
            for _ in range(iters + 2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            out[name]["host_ms_rounds"].append(statistics.median(times[2:]))
    for name, fn in steps.items():
        busy, launches, longest = device_busy_ms(fn, tmp, trace_iters, top)
        host = out[name]["host_ms_rounds"][-1]
        out[name].update(
            host_ms=host, device_busy_ms=busy, top_kernels_ms=longest,
            kernel_launches=launches,
            device_idle_share=None if busy is None else 1 - busy / host)
    return out


def step_line(v) -> str:
    rounds = " / ".join(f"{t:.3f}" for t in v["host_ms_rounds"])
    line = f"host ms to sync, median per round {rounds}; device busy "
    if v["device_busy_ms"] is None:
        return line + "not measured (no device events in the profiler trace)"
    top = ", ".join(f"{n} ({op}) {d:.3f}" for n, d, op in v["top_kernels_ms"])
    return line + (
        f"{v['device_busy_ms']:.3f} ms, idle share "
        f"{v['device_idle_share']:.3f}, {v['kernel_launches']:.0f} kernel "
        f"launches, {1e3 * v['host_ms'] / v['kernel_launches']:.2f} host us "
        f"per launch; top {top}")


# ---------------------------------------------------------------------------
# phase 7: found retraining, test-only, serve of what it trained
# ---------------------------------------------------------------------------

class PhaseLaunches(logging.Handler):
    """The found-cell launch count at the end of each phase of a training
    run, taken when the loop logs the phase's '<phase> Loss:' line.

    This depends on the wording of that line in ``search/loop.py``. If it
    changes, no phase is recorded and ``check_found_artifacts`` fails, since
    it wants exactly {train: 0, dev: 0, test: 2 x batches}."""

    def __init__(self):
        super().__init__()
        self.ends = []

    def emit(self, record):
        from bmnas_tpu_torch.ops.kernels import LAUNCHES
        phase, sep, _ = record.getMessage().partition(" Loss:")
        if sep and phase in ("train", "dev", "test"):
            self.ends.append((phase, LAUNCHES["found_cell"]))

    def per_phase(self, start):
        out, prev = {}, start
        for phase, n in self.ends:
            out[phase] = out.get(phase, 0) + n - prev
            prev = n
        return out


def found_run(s_exp, data):
    """One epoch of ``main_found --search_exp_dir`` on the card; returns
    (eval dir, best test F1, found-cell launches per phase, seconds)."""
    from bmnas_tpu_torch.cli.mmimdb_found import main_found
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    logger = logging.getLogger("bmnas_tpu_torch")
    counter = PhaseLaunches()
    logger.addHandler(counter)
    before = LAUNCHES["found_cell"]
    try:
        t0 = time.perf_counter()
        f1 = main_found(["--search_exp_dir", s_exp, "--datadir", data,
                         "--epochs", "1", "--batchsize", str(BATCH),
                         "--num_workers", "4"])
        seconds = time.perf_counter() - t0
    finally:
        logger.removeHandler(counter)
    (eval_dir,) = glob.glob(os.path.join(s_exp, "eval-EXP-*"))
    return eval_dir, f1, counter.per_phase(before), seconds


def check_found_artifacts(eval_dir, f1, per_phase, test_batches):
    with open(os.path.join(eval_dir, "log.txt")) as f:
        log_text = f.read()
    with open(os.path.join(eval_dir, "metrics.jsonl")) as f:
        rows = [json.loads(r) for r in f]
    best = os.path.join(eval_dir, "best")
    checks = {
        "log.txt train/dev/test lines": all(
            f"{p} Loss:" in log_text for p in ("train", "dev", "test")),
        "metrics.jsonl train+dev+test, finite": [r["phase"] for r in rows]
        == ["train", "dev", "test"]
        and all(math.isfinite(r["loss"]) for r in rows),
        "best_test_model.pt": os.path.exists(
            os.path.join(best, "best_test_model.pt")),
        "best_test_genotype.pkl": os.path.exists(
            os.path.join(best, "best_test_genotype.pkl")),
        "checkpoint.pt": os.path.exists(
            os.path.join(eval_dir, "checkpoint.pt")),
        "architectures/epoch_0": bool(glob.glob(os.path.join(
            eval_dir, "architectures", "epoch_0*"))),
        "test f1 in (0, 1]": 0.0 < f1 <= 1.0,
        "found_cell launches: train 0, dev 0, test 2 x batches":
        per_phase == {"train": 0, "dev": 0, "test": 2 * test_batches},
    }
    if not all(checks.values()):
        raise AssertionError(f"found artifacts: {checks}, launches per "
                             f"phase {per_phase}")
    return {"metrics": rows, "best_test_f1": f1,
            "found_cell_launches_per_phase": per_phase}


def test_only(eval_dir, data, test_batches):
    """``main_found --eval_exp_dir`` on the card: the found-cell kernel
    launches exactly twice per test batch."""
    from bmnas_tpu_torch.cli.mmimdb_found import main_found
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    before = LAUNCHES["found_cell"]
    f1 = main_found(["--eval_exp_dir", eval_dir, "--datadir", data,
                     "--batchsize", str(BATCH), "--num_workers", "4"])
    launched = LAUNCHES["found_cell"] - before
    if not (launched == 2 * test_batches and math.isfinite(f1)):
        raise AssertionError(f"test-only: f1 {f1}, {launched} found_cell "
                             f"launches over {test_batches} batches")
    return {"f1": f1, "launches": launched, "batches": test_batches}


FOUND_STEP_ETAS = (1e-5, 9e-6, 8e-6)


def found_steps_cuda_vs_cpu(devices=("cuda", "cpu")):
    """Three found weight steps (every parameter, the VGG-19 included) from
    the same seeded weights (PyTorch's default init) on CUDA and on the
    CPU, 64x64 images, dropout off, the first batch padded; then each
    side's eval logits on a probe batch: on CUDA through the found-cell
    kernel, on the CPU through its plain version.

    The steps use small learning rates (``FOUND_STEP_ETAS``). Adam moves
    each of the 20 million weights by about eta whatever the size of its
    gradient, and from random weights many VGG-19 gradients are at the
    level of rounding, so at the CLI's eta of 1e-3 three steps part by far
    more than 1e-3 even between fp32 and fp64 on the CPU alone; at 1e-5
    they stay well inside it. The train-mode forwards still move the
    BatchNorm statistics, and with them the logits, by O(1)."""
    from bmnas_tpu_torch.cli.mmimdb import batches_on, counts_fn
    from bmnas_tpu_torch.models.mmimdb import FoundImageTextNet
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    from bmnas_tpu_torch.search.bilevel import (
        TrainState,
        bce_with_logits,
        build_step_functions,
        make_weight_optimizer,
    )
    torch.manual_seed(6)
    model = FoundImageTextNet.from_genotype(serve_genotype(), device="cpu",
                                            **SERVE_CFG)
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    rng = np.random.RandomState(7)
    host = [_synthetic_batch(rng, (64, 64), valid=BATCH - 2),
            _synthetic_batch(rng, (64, 64)), _synthetic_batch(rng, (64, 64)),
            _synthetic_batch(rng, (64, 64))]
    fns = build_step_functions(bce_with_logits, counts_fn)
    out, launched = [], []
    for dev in devices:
        net = copy.deepcopy(model).to(dev)
        state = TrainState(model=net, arch=None,
                           opt_w=make_weight_optimizer(net, (), 1e-4),
                           opt_arch=None)
        *train, probe = batches_on(torch.device(dev), host)
        with torch.no_grad():
            start = net.eval()(probe).float().cpu().numpy()
        for b, eta in zip(train, FOUND_STEP_ETAS):
            fns.weight_step(state, b, eta)
        before = LAUNCHES["found_cell"]
        with torch.no_grad():
            out.append(net.eval()(probe).float().cpu().numpy())
        launched.append(LAUNCHES["found_cell"] - before)
    diff = float(np.abs(out[0] - out[1]).max())
    want_launches = [2 if torch.device(d).type == "cuda" else 0
                     for d in devices]
    if not (np.isfinite(out[0]).all() and diff <= 1e-3
            and launched == want_launches):
        raise AssertionError(f"found steps: eval logits CUDA vs CPU differ "
                             f"by {diff}; found_cell launches {launched}")
    return {"max_abs_diff": diff, "tolerance": 1e-3,
            "logits_abs_max": float(np.abs(out[1]).max()),
            "logits_moved": float(np.abs(out[1] - start).max()),
            "etas": FOUND_STEP_ETAS, "found_cell_launches": launched}


def found_step_times(eval_dir, data, device, tmp):
    """The found weight step (every parameter) and eval step at B=8 on a
    test batch of 160x256 images, from the retrained snapshot
    (``step_times``)."""
    from bmnas_tpu_torch.cli.mmimdb import counts_fn
    from bmnas_tpu_torch.genotype import load_genotype
    from bmnas_tpu_torch.models.mmimdb import FoundImageTextNet
    from bmnas_tpu_torch.search.bilevel import (
        TrainState,
        bce_with_logits,
        build_step_functions,
        make_weight_optimizer,
    )
    from bmnas_tpu_torch.utils.checkpoint import load_model
    best = os.path.join(eval_dir, "best")
    model = FoundImageTextNet.from_genotype(
        load_genotype(os.path.join(best, "best_test_genotype.pkl")),
        device="cpu", **SEARCH_CFG)
    model.load_state_dict(load_model(os.path.join(best,
                                                  "best_test_model.pt")))
    model.to(device)
    state = TrainState(model=model, arch=None,
                       opt_w=make_weight_optimizer(model, (), 1e-4),
                       opt_arch=None)
    fns = build_step_functions(bce_with_logits, counts_fn)
    b = first_batch(data, "test", device)
    return step_times({"weight_step": lambda: fns.weight_step(state, b, 1e-3),
                       "eval_step": lambda: fns.eval_step(state, b)}, tmp)


# ---------------------------------------------------------------------------
# phase 8: --resume on the card
# ---------------------------------------------------------------------------

# the smallest splits that take both epochs through a full batch and a
# ragged one (2 samples) in every phase
RESUME_COUNTS = {"train": 10, "dev": 10, "test": 10}
RESUME_TOL = 1e-6


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN and PyTorch on their deterministic kernels (an op that has
    none warns and runs as it is), the flags restored on exit. cuBLAS reads
    ``CUBLAS_WORKSPACE_CONFIG``, which ``main`` sets before CUDA starts."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    cudnn.deterministic, cudnn.benchmark = True, False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved[0], saved[1]
        torch.use_deterministic_algorithms(saved[2], warn_only=saved[3])


BUFFER_SUFFIXES = ("running_mean", "running_var", "num_batches_tracked")


def resume_leg(run, exp_of):
    """Two epochs in one run against one epoch and ``--resume`` for the
    second, on the card. Compared: the final parameters (the arch tensors
    too in a search), the BatchNorm statistics, and the second epoch's
    ``metrics.jsonl`` rows (loss, F1); the resumed run must have run the
    second epoch only. All are held to ``RESUME_TOL``. Ops that ran
    without a deterministic CUDA kernel (PyTorch warns) are named: where
    they add in another order, the two runs part by rounding, which Adam
    turns into steps of a learning rate on weights with near-zero
    gradients, and the check fails."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(["--epochs", "2", "--save", "WHOLE"])
        run(["--epochs", "1", "--save", "HALF"])
        run(["--epochs", "2", "--save", "RESUMED",
             "--resume", os.path.join(exp_of("HALF"), "checkpoint.pt")])
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught
                     if "does not have a deterministic" in str(w.message)})
    whole, resumed = exp_of("WHOLE"), exp_of("RESUMED")
    ck = [torch.load(os.path.join(d, "checkpoint.pt"), map_location="cpu",
                     weights_only=True) for d in (whole, resumed)]

    def diff(a, b):
        return float((a.double() - b.double()).abs().max())
    params, buffers = [0.0], [0.0]
    for k, v in ck[0]["model"].items():
        if v.is_floating_point():
            (buffers if k.endswith(BUFFER_SUFFIXES) else params).append(
                diff(v, ck[1]["model"][k]))
    if ck[0]["arch"] is not None:
        params += [diff(v, ck[1]["arch"][k]) for k, v in ck[0]["arch"].items()]
    rows = []
    for d in (whole, resumed):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            rows.append([json.loads(r) for r in f])
    resumed_epochs = {r["epoch"] for r in rows[1]}
    first = [r for r in rows[0] if r["epoch"] == 0]
    rows = [[r for r in rs if r["epoch"] == 1] for rs in rows]
    if not (resumed_epochs == {1} and [r["phase"] for r in rows[0]]
            == [r["phase"] for r in rows[1]] == [r["phase"] for r in first]):
        raise AssertionError(f"resume: the resumed run's epochs "
                             f"{resumed_epochs}, second-epoch rows {rows}")
    loss = max(abs(a["loss"] - b["loss"]) for a, b in zip(*rows))
    f1 = max(abs(a["metric"] - b["metric"]) for a, b in zip(*rows))
    res = {"max_abs_diff_params": max(params),
           "max_abs_diff_bn_stats": max(buffers),
           "max_abs_diff_loss": loss, "max_abs_diff_f1": f1,
           "tolerance": RESUME_TOL,
           "loss_change_epoch0_to_1": max(
               abs(a["loss"] - b["loss"]) for a, b in zip(first, rows[0])),
           "ops_without_deterministic_cuda_kernel": nondet,
           "rng_states_equal": bool(
               torch.equal(ck[0]["rng_cpu"], ck[1]["rng_cpu"])
               and all(torch.equal(a, b) for a, b in
                       zip(ck[0]["rng_cuda"] or [], ck[1]["rng_cuda"] or []))),
           "second_epoch_rows": rows}
    if max(res["max_abs_diff_params"], res["max_abs_diff_bn_stats"], loss,
           f1) > RESUME_TOL:
        raise AssertionError(f"resume differs from the uninterrupted run: "
                             f"{res}")
    return res


def resume_phase(root, s_exp):
    """``--resume`` on the card: the search (``main_search``) and found
    retraining (``main_found`` on the phase 6 search's genotype), each two
    epochs straight against one epoch and ``--resume``, the same seed, at
    the full width on 160x256 images, under ``deterministic_algorithms``."""
    from bmnas_tpu_torch.cli.mmimdb import main_found, main_search
    from bmnas_tpu_torch.data.synthetic import make_mmimdb_synthetic
    data = os.path.join(root, "resume_data")
    make_mmimdb_synthetic(data, image_hw=(160, 256), seed=8,
                          correlated=True, counts=RESUME_COUNTS)
    common = ["--datadir", data, "--batchsize", str(BATCH),
              "--num_workers", "4"]
    out = {}
    cwd = os.getcwd()
    os.chdir(root)  # main_search writes final_exp/ under the working dir
    try:
        with deterministic_algorithms():
            out["search"] = resume_leg(
                lambda flags: main_search(common + flags),
                lambda save: glob.glob(os.path.join(
                    root, "final_exp", "mmimdb", f"search-{save}-*"))[0])
            out["found"] = resume_leg(
                lambda flags: main_found(
                    common + ["--search_exp_dir", s_exp] + flags),
                lambda save: glob.glob(os.path.join(
                    s_exp, f"eval-{save}-*"))[0])
    finally:
        os.chdir(cwd)
    return out


# ---------------------------------------------------------------------------
# phase 9: attention vs plain
# ---------------------------------------------------------------------------

# (B, Lq, Lk, C, input scale): the JAX kernel test's five shapes, the
# MM-IMDB width at three lengths, then ragged Lq != Lk
ATTN_CASES = [
    (2, 16, 16, 192, 1.0), (2, 256, 256, 64, 1.0), (1, 100, 100, 64, 1.0),
    (2, 64, 192, 32, 1.0), (1, 64, 64, 32, 30.0),
    (8, 16, 16, 192, 1.0), (8, 512, 512, 192, 1.0),
    (8, 4096, 4096, 192, 1.0),
    (3, 100, 37, 192, 1.0), (2, 1, 300, 64, 1.0), (4, 77, 1, 8, 1.0),
    (2, 130, 65, 24, 1.0),
]
ATTN_TIMED = (16, 512, 4096)  # L at B=8, C=192, fp32
ATTN_SWEPT = (512, 4096)  # L of the geometry sweep and the ablation


def attention_bound_ms(B, Lq, Lk, Cc, itemsize):
    """x and y read once in their type, the fp32 output written once;
    4 B Lq Lk C FLOP (two products), the JAX kernel's cost estimate."""
    nbytes = itemsize * B * (Lq + Lk) * Cc + 4 * B * Lq * Cc
    flops = 4 * B * Lq * Lk * Cc
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_tc_bound_ms(B, Lq, Lk, Cc, itemsize):
    """A second bound beside ``attention_bound_ms``, as
    ``mixed_tc_bound_ms``: the same bytes and FLOP, the FLOP at the tensor
    cores' dense rate (TF32 for fp32 inputs, bf16 for bf16). The kernel
    runs 3xTF32 for fp32, three TF32 products for each fp32 one, so this
    bound is not reachable there."""
    nbytes = itemsize * B * (Lq + Lk) * Cc + 4 * B * Lq * Cc
    rate = TF32_FLOP_PER_S if itemsize == 4 else BF16_FLOP_PER_S
    return max(nbytes / HBM_BYTES_PER_S, 4 * B * Lq * Lk * Cc / rate) * 1e3


def attention_phase(device):
    """Every case in fp32 and bf16 against the plain version: one launch
    each."""
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    from bmnas_tpu_torch.ops.kernels.attention import (
        blockwise_scaled_dot_attention,
        reference_attention,
    )
    gen = torch.Generator().manual_seed(2)
    rows = []
    for B, Lq, Lk, Cc, scale in ATTN_CASES:
        x32 = (torch.randn(B, Lq, Cc, generator=gen) * scale).to(device)
        y32 = (torch.randn(B, Lk, Cc, generator=gen) * scale).to(device)
        for dtype in (torch.float32, torch.bfloat16):
            x, y = x32.to(dtype), y32.to(dtype)
            before = LAUNCHES["attention"]
            got = blockwise_scaled_dot_attention(x, y)
            torch.cuda.synchronize()
            launched = LAUNCHES["attention"] - before
            want = reference_attention(x, y)
            # Both sides read the same bf16 values and accumulate in fp32,
            # so bf16 is held to the fp32 tolerances.
            rtol, atol = (2e-4, 2e-5) if scale == 1.0 else (1e-3, 1e-3)
            err = (got - want).abs()
            ok = (got.dtype == torch.float32 and got.shape == want.shape
                  and bool(torch.isfinite(got).all())
                  and bool((err <= atol + rtol * want.abs()).all()))
            row = {"B": B, "Lq": Lq, "Lk": Lk, "C": Cc, "scale": scale,
                   "dtype": str(dtype).split(".")[-1], "launches": launched,
                   "max_abs_err": float(err.max()), "rtol": rtol,
                   "atol": atol, "ok": ok}
            rows.append(row)
            log("  attention B={B:<2} Lq={Lq:<5} Lk={Lk:<5} C={C:<4} "
                "x{scale:<3g} {dtype:<8} max_abs_err={max_abs_err:.3g} "
                "ok={ok}".format(**row))
            if not ok or launched != 1:
                raise AssertionError(f"attention disagrees with its plain "
                                     f"version: {row}")
    return rows


def attention_times(device):
    """At B=8, C=192, fp32, for each L of ``ATTN_TIMED``: the kernel, the
    plain version and ``scaled_dot_product_attention`` (CUDA events,
    median, L2 flushed), the kernel's time over the library's and the
    geometry the launcher picked, beside both bounds."""
    from bmnas_tpu_torch.ops.kernels import _build
    from bmnas_tpu_torch.ops.kernels.attention import (
        bind,
        blockwise_scaled_dot_attention,
        geometry,
        reference_attention,
    )
    lib = _build.load("attention", bind)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator().manual_seed(4)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    out = {}
    for Ll in ATTN_TIMED:
        x = torch.randn(BATCH, Ll, C, generator=gen).to(device)
        y = torch.randn(BATCH, Ll, C, generator=gen).to(device)
        t = {"ms": time_ms(lambda: blockwise_scaled_dot_attention(x, y),
                           flush, True),
             "plain_ms": time_ms(lambda: reference_attention(x, y), flush,
                                 True),
             "library_ms": time_ms(lambda: sdpa(x, y, y), flush, True)}
        t["ms_over_library"] = t["ms"] / t["library_ms"]
        t["bound_ms"], t["bound_by"] = attention_bound_ms(BATCH, Ll, Ll, C, 4)
        t["tc_bound_ms"] = attention_tc_bound_ms(BATCH, Ll, Ll, C, 4)
        t["geometry"] = geometry(lib, BATCH, Ll, Ll, C, 4)
        out[Ll] = t
        log("  attention B=8 L={} C=192 fp32: ms={ms:.4f} plain_ms="
            "{plain_ms:.4f} library_ms={library_ms:.4f} ms/library="
            "{ms_over_library:.3f} bound_ms={bound_ms:.5f} ({bound_by}) "
            "tc_bound_ms={tc_bound_ms:.5f} geometry={geometry}".format(
                Ll, **t))
    return out


def attention_sweep(device):
    """Every geometry the launcher could take (query groups a block, warps
    a group, keys a tile) at B=8, C=192, fp32, L in (512, 4096): the
    kernel's time under each (CUDA events, median, L2 flushed), checked
    against the plain version once; the launcher's pick is marked."""
    from bmnas_tpu_torch.ops.kernels import _build
    from bmnas_tpu_torch.ops.kernels.attention import (
        bind,
        geometry,
        launch,
        reference_attention,
    )
    lib = _build.load("attention", bind)
    gen = torch.Generator().manual_seed(5)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    rows = []
    for Ll in ATTN_SWEPT:
        x = torch.randn(BATCH, Ll, C, generator=gen).to(device)
        y = torch.randn(BATCH, Ll, C, generator=gen).to(device)
        want = reference_attention(x, y)
        pick = geometry(lib, BATCH, Ll, Ll, C, 4)
        stream = torch.cuda.current_stream(device).cuda_stream
        for wq in (1, 2, 4):
            for wc in (1, 2, 4):
                for bk in (32, 64):
                    try:
                        g = geometry(lib, BATCH, Ll, Ll, C, 4, wq, wc, bk)
                    except ValueError:
                        continue
                    def run(wq=wq, wc=wc, bk=bk):
                        return launch(lib, x, y, stream, wq, wc, bk)
                    err = float((run() - want).abs().max())
                    row = dict(g, L=Ll, ms=time_ms(run, flush, True),
                               max_abs_err=err,
                               picked=(wq, wc, bk) == (pick["wq"],
                                                       pick["wc"],
                                                       pick["bk"]))
                    rows.append(row)
                    log("  attention sweep L={L:<5} wq={wq} wc={wc} bk={bk:<2}"
                        " blocks={blocks:<4} per SM={blocks_per_sm} ms="
                        "{ms:.4f} max_abs_err={max_abs_err:.3g}{mark}".format(
                            mark=" (the launcher's pick)" if row["picked"]
                            else "", **row))
    return rows


# The ablation: copies of csrc/attention.cu and its headers, each
# with one part of the work taken out (file, text, replacement); what a
# removal saves is what that part costs. Their outputs are wrong by design
# and are not checked. The compiler drops the loads and operand splits
# whose products are gone, so "S" and "P V" time each product whole.
ATTN_ABLATIONS = {
    "S lo terms": [("tc_gemm.cuh",
                    "    wmma::mma_sync(acc[0], a.lo, b.hi, acc[0]);\n"
                    "    wmma::mma_sync(acc[1], a.hi, b.lo, acc[1]);\n", "")],
    "P V lo terms": [("tc_gemm.cuh",
                      "#pragma unroll\n    for (int c = 0; c < N; ++c) "
                      "wmma::mma_sync(acc[c], a.lo, b[c].hi, acc[c]);\n"
                      "#pragma unroll\n    for (int c = 0; c < N; ++c) "
                      "wmma::mma_sync(acc[c], a.hi, b[c].lo, acc[c]);\n",
                      "")],
    "S": [("attention.cu", "Step::mma_terms(s[u], a, bt[u]);", ";")],
    "P V": [("attention.cu", "F32::mma(o, pa, bv);", ";"),
            ("attention.cu", "F32::mma_exact_b(o, pa, bv);", ";")],
    "exp2": [("attention.cu", "exp2f(sv[e] - m_new)", "(sv[e] - m_new)")],
}
ATTN_ABLATIONS["S and P V"] = ATTN_ABLATIONS["S"] + ATTN_ABLATIONS["P V"]


def attention_ablation(device):
    """Each variant of ``ATTN_ABLATIONS`` built (one nvcc each, all at
    once) and timed against the kernel itself at B=8, C=192, fp32, L in
    ``ATTN_SWEPT``, under the kernel's own geometry (CUDA events, median,
    L2 flushed)."""
    import ctypes
    from bmnas_tpu_torch.ops.kernels import _build
    from bmnas_tpu_torch.ops.kernels.attention import bind, geometry, launch
    root = os.path.join(_build.BUILD_DIR, "ablation")
    procs = {}
    for name, subs in ATTN_ABLATIONS.items():
        d = os.path.join(root, name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        for fname in ("attention.cu", "tc_gemm.cuh", "cell_common.cuh"):
            with open(os.path.join(_build.CSRC, fname)) as f:
                text = f.read()
            for target, old, new in subs:
                if target == fname:
                    if old not in text:
                        raise AssertionError(f"ablation {name!r}: text not "
                                             f"found in {fname}")
                    text = text.replace(old, new, 1)
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        procs[name] = (d, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"none (the kernel)": _build.load("attention", bind)}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"ablation {name!r} did not build:\n{out}")
        libs[name] = bind(ctypes.CDLL(os.path.join(d, "lib.so")))
    gen = torch.Generator().manual_seed(7)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    rows = []
    for Ll in ATTN_SWEPT:
        x = torch.randn(BATCH, Ll, C, generator=gen).to(device)
        y = torch.randn(BATCH, Ll, C, generator=gen).to(device)
        g = geometry(libs["none (the kernel)"], BATCH, Ll, Ll, C, 4)
        full = None
        for name, lib in libs.items():
            def run(lib=lib):
                return launch(lib, x, y, stream, g["wq"], g["wc"], g["bk"])
            ms = time_ms(run, flush, True)
            full = ms if full is None else full
            rows.append({"L": Ll, "removed": name, "ms": ms,
                         "saved_ms": full - ms})
            log(f"  attention ablation L={Ll:<5} removed {name:<18} "
                f"ms={ms:.4f} saved_ms={full - ms:.4f}")
    return rows


def attention_memory(device, B=8, Ll=8192):
    """The kernel at B=8, Lq=Lk=8192, C=192 fp32 raises the peak of
    allocated device memory by at most its output plus 1 MiB (the dense
    scores would take B L^2 4 bytes); its first sample agrees with the
    plain version."""
    from bmnas_tpu_torch.ops.kernels.attention import (
        blockwise_scaled_dot_attention,
        reference_attention,
    )
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(B, Ll, C, generator=gen).to(device)
    y = torch.randn(B, Ll, C, generator=gen).to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    out = blockwise_scaled_dot_attention(x, y)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated(device) - base
    limit = out.numel() * 4 + 2**20
    want = reference_attention(x[:1], y[:1])
    err = (out[:1] - want).abs()
    ok_values = bool((err <= 2e-5 + 2e-4 * want.abs()).all())
    res = {"B": B, "L": Ll, "C": C, "peak_growth_bytes": grew,
           "limit_bytes": limit, "output_bytes": out.numel() * 4,
           "dense_scores_bytes": B * Ll * Ll * 4,
           "first_sample_max_abs_err": float(err.max())}
    if grew > limit or not ok_values:
        raise AssertionError(f"attention at L={Ll}: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 10: NTU serve
# ---------------------------------------------------------------------------

# the NTU found defaults (cli/ntu.py::parse_found_args)
NTU_CFG = dict(C=NTU_C, L=NTU_L, steps=4, multiplier=2, node_steps=2,
               node_multiplier=2, num_input_nodes=8, num_keep_edges=2,
               num_outputs=60, drpt=0.2)
# one full batch of 96 and one of 4 samples padded to 96 (the dataset pads
# every batch to full); clips of 8 frames at 256x256
NTU_SAMPLES, NTU_BATCH, NTU_HW = 100, 96, 256
NTU_CPU_SAMPLES = 2  # the CUDA vs CPU batch, at the full width


def ntu_genotype():
    """Four found cells of two chained inner steps (the second step reads
    the first's output), every inner op among them, inner concat of both
    steps (multiplier 2, so each cell runs the out-conv); the third and
    fourth cells read the first and second cells' outputs, and inputs 2
    (fm4) and 6 (out7) are left out."""
    from bmnas_tpu_torch.genotype import Genotype, StepGenotype
    return Genotype(
        edges=[("skip", 0), ("skip", 4), ("skip", 3), ("skip", 5),
               ("skip", 8), ("skip", 1), ("skip", 9), ("skip", 7)],
        concat=[10, 11],
        steps=[StepGenotype([("skip", 0), ("skip", 1), ("skip", 1),
                             ("skip", 2)], list(ops), [2, 3])
               for _, _, ops in NTU_KERNEL_CONFIGS])


def seeded_ntu_net(seed):
    """The NTU genotype's found net at the full width on the CPU:
    convolutions He-initialised, BatchNorm affines randomized, then the
    BatchNorm statistics taken from one train-mode pass over 8 random
    8x256x256 clips: random, so that folding is exercised, and true to
    the activations, so that those stay O(1) through the 16 bottlenecks
    (statistics drawn at random compound over the depth, and the taps grow
    to 1e3 and the reshaped pooled vector to 1e4)."""
    from bmnas_tpu_torch.models.ntu import FoundSkeletonImageNet
    torch.manual_seed(seed)
    model = FoundSkeletonImageNet.from_genotype(ntu_genotype(), device="cpu",
                                                **NTU_CFG)
    gen = torch.Generator().manual_seed(seed + 1)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)]
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Conv3d)):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                                   generator=gen)
        for bn in bns:
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0.0, 0.1, generator=gen)
            bn.momentum = 1.0  # the running statistics become the batch's
        model.train()({
            "image": torch.randint(0, 256, (8, 8, NTU_HW, NTU_HW, 3),
                                   generator=gen, dtype=torch.uint8),
            "skeleton": torch.randn(8, 32, 25, 2, 3, generator=gen) * 0.1,
            "mask": torch.ones(8)})
        for bn in bns:
            bn.momentum = 0.1
    return model.eval()


def write_ntu_experiment(root):
    """A synthetic NTU test split (uint8 .npy clips of 8 frames at 256x256,
    40-frame skeletons, the test subjects) and a found experiment dir."""
    from bmnas_tpu_torch.data.ntu import SUBJECTS
    from bmnas_tpu_torch.data.synthetic import make_ntu_synthetic
    from bmnas_tpu_torch.genotype import save_genotype
    from bmnas_tpu_torch.utils.checkpoint import save_model
    data = os.path.join(root, "ntu_data")
    subjects = SUBJECTS["test"]
    make_ntu_synthetic(data, n_videos_per_subject=NTU_SAMPLES // len(
        subjects), subjects=subjects, num_actions=NTU_CFG["num_outputs"],
        hw=NTU_HW, frames=8, ske_frames=40, seed=0)
    best = os.path.join(root, "ntu_exp", "best")
    os.makedirs(best)
    save_genotype(ntu_genotype(), os.path.join(best, "best_genotype.pkl"))
    save_model(os.path.join(best, "best_model.pt"), seeded_ntu_net(0))
    return data, os.path.join(root, "ntu_exp")


def ntu_serve_once(data, exp, bf16):
    """``main_serve --task ntu`` at the NTU defaults; 4 found-cell launches
    a batch (one a found cell)."""
    from bmnas_tpu_torch.cli.serve import main_serve
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    argv = ["--task", "ntu", "--eval_exp_dir", exp, "--datadir", data,
            "--batchsize", str(NTU_BATCH), "--num_workers", "8"] + (
                ["--bf16"] if bf16 else [])
    before = LAUNCHES["found_cell"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main_serve(argv)
    printed = buf.getvalue()
    sys.stdout.write(printed)
    launched = LAUNCHES["found_cell"] - before
    line = json.loads(printed.strip().splitlines()[-1])
    n_batches = -(-NTU_SAMPLES // NTU_BATCH)
    checks = {
        "printed == returned": line == result,
        "metric": result["metric"] == "accuracy",
        "samples": result["samples"] == NTU_SAMPLES,
        "batches": result["batches"] == n_batches,
        "launches == 4 x batches": launched == 4 * n_batches,
        "finite logits": result["logits_finite"],
        "accuracy in [0, 1]": 0.0 <= result["value"] <= 1.0,
    }
    if not all(checks.values()):
        raise AssertionError(f"NTU serve (bf16={bf16}) failed {checks}: "
                             f"{result}, launches={launched}")
    return dict(result, launches=launched)


def ntu_server(exp, device, dtype=torch.float32):
    from bmnas_tpu_torch.genotype import load_genotype
    from bmnas_tpu_torch.models.ntu import FoundSkeletonImageNet
    from bmnas_tpu_torch.serving import load_server
    geno = load_genotype(os.path.join(exp, "best", "best_genotype.pkl"))
    model = FoundSkeletonImageNet.from_genotype(geno, device=device,
                                                **NTU_CFG)
    return load_server(os.path.join(exp, "best", "best_model.pt"), model,
                       dtype=dtype, device=device)


def ntu_cuda_vs_cpu(data, exp):
    """The first 2 test samples' logits at the full width: the port on CUDA
    (through the kernel) against the port on the CPU (plain PyTorch), TF32
    off on both sides, within phase 5's 1e-3; and the CUDA server in bf16
    against it in fp32 (``bf16_vs_fp32``)."""
    from bmnas_tpu_torch.data.ntu import NTUDataset
    batch = next(iter(NTUDataset(data, "test", num_workers=2).batches(
        NTU_CPU_SAMPLES, shuffle=False)))
    out = {dev: ntu_server(exp, dev).predict(batch)
           for dev in ("cuda", "cpu")}
    diff = float(np.abs(out["cuda"] - out["cpu"]).max())
    if not (np.isfinite(out["cuda"]).all() and diff <= 1e-3):
        raise AssertionError(f"NTU CUDA vs CPU logits differ by {diff}")
    return {"samples": NTU_CPU_SAMPLES, "max_abs_diff": diff,
            "logits_abs_max": float(np.abs(out["cpu"]).max()),
            "tolerance": 1e-3,
            "bf16_vs_fp32": bf16_vs_fp32(
                lambda dt: ntu_server(exp, "cuda", dt), batch, out["cuda"],
                ("rgbnet",), ("skeleton",))}


def bf16_vs_fp32(server_of, batch, ref, backbones, float_keys=()):
    """The bf16 CUDA server's logits against the fp32 ones (``ref``);
    ``server_of(dtype)`` builds a CUDA server.

    The seeded net amplifies small changes: in fp32, its input changed by
    bf16's unit roundoff alone moves its logits by a large share of their
    spread. So the bound is measured on the same batch: ``rounded`` runs
    in fp32 the net that a bf16 server holds (every weight but the
    BatchNorms', which it keeps in fp32, rounded to bf16) on the input
    that it sees (the batch's ``float_keys`` and each of ``backbones``'
    normalized input rounded to bf16). The bf16 server also rounds its
    activations, an error of the same order; its logits must lie within
    2x the distance of ``rounded``'s from ``ref``, plus 1e-3. The fp32 net
    on the rounded input alone is reported beside them."""
    from bmnas_tpu_torch.models.foundnet import FoundNodeCell
    bf16 = server_of(torch.bfloat16).predict(batch)
    server = server_of(torch.float32)
    model = server.model
    hooks = [model.get_submodule(n).register_forward_pre_hook(
        lambda m, args: (args[0].to(torch.bfloat16).float(),))
        for n in backbones]
    batch16 = dict(batch, **{k: torch.from_numpy(batch[k]).to(
        torch.bfloat16).float().numpy() for k in float_keys})
    input_only = server.predict(batch16)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                continue
            for t in [*m.parameters(recurse=False),
                      *m.buffers(recurse=False)]:
                if t.is_floating_point():
                    t.copy_(t.to(torch.bfloat16).float())
        for m in model.modules():
            if isinstance(m, FoundNodeCell):
                m.fold()
    rounded = server.predict(batch16)
    for h in hooks:
        h.remove()
    d16 = float(np.abs(bf16 - ref).max())
    yard = float(np.abs(rounded - ref).max())
    if not (np.isfinite(bf16).all() and d16 <= 2 * yard + 1e-3):
        raise AssertionError(f"bf16 vs fp32 CUDA logits differ by {d16}; "
                             f"the fp32 net of bf16-rounded weights and "
                             f"input by {yard}")
    return {"max_abs_diff": d16, "mean_abs_diff": float(
                np.abs(bf16 - ref).mean()),
            "rounded_fp32_max_abs_diff": yard,
            "rounded_fp32_mean_abs_diff": float(np.abs(rounded - ref).mean()),
            "input_rounded_fp32_max_abs_diff": float(
                np.abs(input_only - ref).max()),
            "tolerance": "2 x rounded_fp32_max_abs_diff + 1e-3"}


def ntu_breakdown(data, exp, dtype, tmp, iters=5):
    """``request_breakdown`` of a request of 96 at the NTU defaults, then a
    profiler trace of 2 more requests: device busy ms, the idle share of
    the median ``predict``, kernel launches and the 8 longest kernels."""
    from bmnas_tpu_torch.data.ntu import NTUDataset
    server = ntu_server(exp, "cuda", dtype)
    parts = (["rgbnet", "skenet"]
             + [f"reshape_{i}" for i in server.model.used]
             + ["fusion_net", "central_classifier"])
    dataset = NTUDataset(data, "test", num_workers=8)
    out = request_breakdown(server, dataset, NTU_BATCH, parts, iters)
    batch = next(iter(dataset.batches(NTU_BATCH, shuffle=False)))
    busy, launches, top = device_busy_ms(lambda: server.predict(batch), tmp,
                                         iters=2, top=8)
    out.update(device_busy_ms=busy, kernel_launches=launches,
               top_kernels_ms=top, device_idle_share=None if busy is None
               else 1 - busy / out["predict_ms"])
    return out


def ntu_conv_flop(batch):
    """FLOP of the NTU net's convolutions on one batch (2 per multiply-add),
    counted by forward hooks on a copy on the meta device (no data, no
    compute): (inflated ResNet-50, HCN)."""
    from bmnas_tpu_torch.models.ntu import FoundSkeletonImageNet
    model = FoundSkeletonImageNet.from_genotype(ntu_genotype(), device="meta",
                                                **NTU_CFG).eval()
    flop = {"rgbnet": 0, "skenet": 0}
    for part in flop:
        for mod in model.get_submodule(part).modules():
            if isinstance(mod, (torch.nn.Conv2d, torch.nn.Conv3d)):
                mod.register_forward_hook(
                    lambda m, a, o, part=part: flop.__setitem__(
                        part,
                        flop[part] + 2 * o.numel() * m.weight[0].numel()))
    T, Ts = 8, 32
    with torch.no_grad():
        model({"image": torch.zeros(batch, T, NTU_HW, NTU_HW, 3,
                                    dtype=torch.uint8, device="meta"),
               "skeleton": torch.zeros(batch, Ts, 25, 2, 3, device="meta"),
               "mask": torch.ones(batch, device="meta")})
    return flop


def ntu_phase(root):
    """Phase 10: the NTU found net served at the NTU defaults. Returns the
    report and the launch counts of the serve runs (the main path)."""
    from bmnas_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    t0 = time.perf_counter()
    data, exp = write_ntu_experiment(root)
    out = {"write_s": time.perf_counter() - t0}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for convs
    reset_launches()
    out["fp32"] = ntu_serve_once(data, exp, bf16=False)
    out["bf16"] = ntu_serve_once(data, exp, bf16=True)
    launches = dict(LAUNCHES)
    torch.backends.cudnn.allow_tf32 = False
    out["cuda_vs_cpu"] = ntu_cuda_vs_cpu(data, exp)
    log(f"  cuda vs cpu logits: {out['cuda_vs_cpu']}")
    torch.backends.cudnn.allow_tf32 = True
    out["breakdown"] = [ntu_breakdown(data, exp, dt, root)
                        for dt in (torch.float32, torch.bfloat16)]
    out["conv_flop_per_batch"] = flop = ntu_conv_flop(NTU_BATCH)
    for b in out["breakdown"]:
        b["rgbnet_conv_tflop_per_s"] = (
            flop["rgbnet"] / b["layer_device_ms"]["rgbnet"] / 1e9)
        log("  breakdown {dtype}, batch {batch}: load {load_ms_per_batch:.3f}"
            " ms/batch, predict {predict_ms:.3f} ms (median of {n}), other "
            "{other_ms:.3f} ms, layers (device) ".format(
                n=len(b["predict_ms_all"]), **b) + ", ".join(
                f"{k} {v:.4f}" for k, v in b["layer_device_ms"].items())
            + "; rgbnet convs {:.3f} TFLOP a batch at {:.1f} TFLOP/s".format(
                flop["rgbnet"] / 1e12, b["rgbnet_conv_tflop_per_s"]))
        if b["device_busy_ms"] is None:
            log("  trace {dtype}: device busy not measured (no device events "
                "in the profiler trace)".format(**b))
        else:
            log("  trace {dtype}: device busy {device_busy_ms:.3f} ms a "
                "request, idle share {device_idle_share:.3f}, "
                "{kernel_launches:.0f} kernel launches; top ".format(**b)
                + ", ".join(f"{n} ({op}) {d:.3f}"
                            for n, d, op in b["top_kernels_ms"]))
    out["seconds"] = time.perf_counter() - t0
    return out, launches


# ---------------------------------------------------------------------------
# phase 11: NTU search and found retraining
# ---------------------------------------------------------------------------

# the NTU search defaults (cli/ntu.py::parse_search_args): the found ones
# but for steps 2
NTU_SEARCH_CFG = dict(NTU_CFG, steps=2)
# 60 clips a subject for two subjects of each split, train_exp (1, 8), dev
# (2, 5) and test (3, 6): 120 in each search split (a batch of 96 and one
# of 24), 240 in train_val (96, 96, 48) and 120 in test; clips of 16
# frames at 256x256 (the train crop keeps 8-16 of them, the resample 8)
NTU_TRAIN_SUBJECTS = (1, 8, 2, 5, 3, 6)
NTU_TRAIN_PER_SUBJECT, NTU_TRAIN_FRAMES = 60, 16
NTU_STEP_ETA = 1e-5  # the CUDA vs CPU steps' learning rate (FOUND_STEP_ETAS)
NTU_REMAT_BATCH, NTU_REMAT_TOL = 8, 1e-5


def write_ntu_train_data(root):
    from bmnas_tpu_torch.data.synthetic import make_ntu_synthetic
    return make_ntu_synthetic(
        os.path.join(root, "ntu_train_data"),
        n_videos_per_subject=NTU_TRAIN_PER_SUBJECT,
        subjects=NTU_TRAIN_SUBJECTS, num_actions=NTU_CFG["num_outputs"],
        hw=NTU_HW, frames=NTU_TRAIN_FRAMES, ske_frames=40, seed=12)


def ntu_first_batch(data, split, device, batch=NTU_BATCH, train=False):
    """The first batch of a split, unshuffled (with the train crop of epoch
    seed 0 when ``train``), on ``device``."""
    from bmnas_tpu_torch.cli.mmimdb import batches_on
    from bmnas_tpu_torch.data.ntu import NTUDataset
    ds = NTUDataset(data, split, num_workers=8, train_transform=train)
    (b,) = batches_on(device, [next(iter(ds.batches(batch, shuffle=False)))])
    return b


def ntu_split_batches(data, split):
    from bmnas_tpu_torch.data.ntu import NTUDataset
    return NTUDataset(data, split, num_workers=1).num_batches(NTU_BATCH)


def read_exp(exp):
    with open(os.path.join(exp, "log.txt")) as f:
        text = f.read()
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(r) for r in f]
    return text, rows


def acc_rows_ok(rows, phases):
    return ([r["phase"] for r in rows] == list(phases)
            and all(r["metric_name"] == "acc" and math.isfinite(r["loss"])
                    and 0.0 <= r["metric"] <= 1.0 for r in rows))


def ntu_search_run(root, data):
    """One epoch of the NTU ``main_search`` at the search defaults on the
    card; checks its files; returns (exp dir, report). The mixed-op kernel
    must not launch: the loop runs train-mode steps only."""
    from bmnas_tpu_torch.cli.ntu import main_search
    from bmnas_tpu_torch.genotype import load_genotype
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    cwd = os.getcwd()
    os.chdir(root)  # main_search writes final_exp/ under the working dir
    try:
        before = LAUNCHES["node_mixed"]
        t0 = time.perf_counter()
        best_acc, geno = main_search(["--datadir", data, "--epochs", "1",
                                      "--num_workers", "8"])
        seconds = time.perf_counter() - t0
        launched = LAUNCHES["node_mixed"] - before
    finally:
        os.chdir(cwd)
    (exp,) = glob.glob(os.path.join(root, "final_exp", "ntu", "search-EXP-*"))
    text, rows = read_exp(exp)
    pkl = os.path.join(exp, "best", "best_genotype.pkl")
    checks = {
        "log.txt train/dev Acc lines and best dev accuracy": all(
            t in text for t in ("train Loss:", "dev Loss:", " Acc: ",
                                "Current best dev accuracy:")),
        "metrics.jsonl train+dev, acc, finite": acc_rows_ok(
            rows, ("train", "dev")),
        "checkpoint.pt": os.path.exists(os.path.join(exp, "checkpoint.pt")),
        "best_model.pt": os.path.exists(os.path.join(exp, "best",
                                                     "best_model.pt")),
        "best_genotype.pkl, 2 inner steps a cell": os.path.exists(pkl)
        and load_genotype(pkl) == geno
        and all(len(st.inner_steps) == 2 for st in geno.steps),
        "node_mixed launches in the loop: 0": launched == 0,
    }
    if not all(checks.values()):
        raise AssertionError(f"NTU search: {checks}")
    return exp, {"seconds": seconds, "best_dev_acc": best_acc,
                 "metrics": rows, "genotype": str(geno),
                 "node_mixed_launches_in_loop": launched}


def ntu_search_model(exp, device):
    from bmnas_tpu_torch.models.ntu import SearchableSkeletonImageNet
    from bmnas_tpu_torch.utils.checkpoint import load_checkpoint
    sd, arch = load_checkpoint(os.path.join(exp, "best", "best_model.pt"))
    model = SearchableSkeletonImageNet(**NTU_SEARCH_CFG)
    model.load_state_dict(sd)
    return model.to(device), {k: v.to(device) for k, v in arch.items()}


def ntu_search_eval(exp, data, device):
    """The supernet's eval step on a dev batch of 96: steps x node_steps =
    4 mixed-op launches."""
    from bmnas_tpu_torch.cli.ntu import counts_fn
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    from bmnas_tpu_torch.search.bilevel import (
        TrainState,
        build_step_functions,
        cross_entropy,
    )
    model, arch = ntu_search_model(exp, device)
    state = TrainState(model=model, arch=arch, opt_w=None, opt_arch=None)
    b = ntu_first_batch(data, "dev", device)
    before = LAUNCHES["node_mixed"]
    c = build_step_functions(cross_entropy, counts_fn).eval_step(state, b)
    torch.cuda.synchronize()
    launched = LAUNCHES["node_mixed"] - before
    want = NTU_SEARCH_CFG["steps"] * NTU_SEARCH_CFG["node_steps"]
    loss = float(c["loss_sum"]) / float(c["valid"])
    if not (launched == want and math.isfinite(loss)):
        raise AssertionError(f"NTU search eval step: {launched} node_mixed "
                             f"launches (want {want}), loss {loss}")
    return {"launches": launched, "batch": NTU_BATCH, "loss": loss,
            "correct": float(c["correct"])}


def write_ntu_found_exp(root):
    """A search experiment dir that holds phase 10's four-cell genotype,
    which reads video inputs 0, 1 and 3: found retraining on it trains the
    3D ResNet (a searched genotype may read skeleton inputs only, and then
    no gradient reaches the ResNet) and has one cell a found step of the
    found defaults (steps 4)."""
    from bmnas_tpu_torch.genotype import save_genotype
    exp = os.path.join(root, "ntu_genotype_exp")
    os.makedirs(os.path.join(exp, "best"))
    save_genotype(ntu_genotype(), os.path.join(exp, "best",
                                               "best_genotype.pkl"))
    return exp


def ntu_found_run(s_exp, data, cells, test_batches):
    """One epoch of the NTU ``main_found --search_exp_dir --remat`` at the
    found defaults; the found-cell kernel launches in the test phase only,
    once a cell and test batch."""
    from bmnas_tpu_torch.cli.ntu import main_found
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    logger = logging.getLogger("bmnas_tpu_torch")
    counter = PhaseLaunches()
    logger.addHandler(counter)
    before = LAUNCHES["found_cell"]
    try:
        t0 = time.perf_counter()
        acc = main_found(["--search_exp_dir", s_exp, "--datadir", data,
                          "--epochs", "1", "--remat", "--num_workers", "8"])
        seconds = time.perf_counter() - t0
    finally:
        logger.removeHandler(counter)
    per_phase = counter.per_phase(before)
    (eval_dir,) = glob.glob(os.path.join(s_exp, "eval-EXP-*"))
    text, rows = read_exp(eval_dir)
    best = os.path.join(eval_dir, "best")
    checks = {
        "log.txt train/test Acc lines": all(
            t in text for t in ("train Loss:", "test Loss:", " Acc: ",
                                "Current best test accuracy:")),
        "metrics.jsonl train+test, acc, finite": acc_rows_ok(
            rows, ("train", "test")),
        "best_test_model.pt, best_test_genotype.pkl, checkpoint.pt": all(
            os.path.exists(p) for p in (
                os.path.join(best, "best_test_model.pt"),
                os.path.join(best, "best_test_genotype.pkl"),
                os.path.join(eval_dir, "checkpoint.pt"))),
        "acc in [0, 1]": 0.0 <= acc <= 1.0,
        "found_cell launches: train 0, test cells x batches":
        per_phase == {"train": 0, "test": cells * test_batches},
    }
    if not all(checks.values()):
        raise AssertionError(f"NTU found: {checks}, launches per phase "
                             f"{per_phase}")
    return eval_dir, {"seconds": seconds, "best_test_acc": acc,
                      "metrics": rows,
                      "found_cell_launches_per_phase": per_phase}


def ntu_test_only(eval_dir, data, cells, test_batches):
    from bmnas_tpu_torch.cli.ntu import main_found
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    before = LAUNCHES["found_cell"]
    acc = main_found(["--eval_exp_dir", eval_dir, "--datadir", data,
                      "--num_workers", "8"])
    launched = LAUNCHES["found_cell"] - before
    if not (launched == cells * test_batches and 0.0 <= acc <= 1.0):
        raise AssertionError(f"NTU test-only: acc {acc}, {launched} "
                             f"found_cell launches over {test_batches} "
                             f"batches of {cells} cells")
    return {"acc": acc, "launches": launched, "batches": test_batches}


def ntu_serve_eval_dir(eval_dir, data, cells, test_batches):
    from bmnas_tpu_torch.cli.serve import main_serve
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    before = LAUNCHES["found_cell"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main_serve(["--task", "ntu", "--eval_exp_dir", eval_dir,
                             "--datadir", data, "--num_workers", "8"])
    sys.stdout.write(buf.getvalue())
    launched = LAUNCHES["found_cell"] - before
    if not (result["metric"] == "accuracy" and 0.0 <= result["value"] <= 1.0
            and result["logits_finite"]
            and launched == cells * test_batches):
        raise AssertionError(f"NTU serve of the eval dir: {result}, "
                             f"{launched} found_cell launches")
    return dict(result, launches=launched)


def _tiny_ntu_batches(rng, n, hw, count):
    """``count`` host batches of ``n`` samples: uint8 clips of 8 frames at
    hw x hw, 32-frame skeletons, labels of the 60 classes."""
    return [{"image": rng.randint(0, 256, (n, 8, hw, hw, 3)).astype(np.uint8),
             "skeleton": (rng.randn(n, 32, 25, 2, 3) * 0.1).astype(
                 np.float32),
             "label": rng.randint(0, 60, (n,)).astype(np.int32),
             "mask": np.ones((n,), np.float32)} for _ in range(count)]


def ntu_steps_cuda_vs_cpu(devices=("cuda", "cpu")):
    """From the same seeded weights on CUDA and on the CPU, 2 samples at
    the full width with 64x64 clips, dropout off: one NTU search weight
    step and one arch step, then the supernet's eval logits (on CUDA through
    the mixed-op kernel); one found weight step (phase 10's four-cell
    genotype), then its eval logits (on CUDA through the found-cell
    kernel). Each within 1e-3; the weight steps at ``NTU_STEP_ETA`` (see
    ``found_steps_cuda_vs_cpu``)."""
    from bmnas_tpu_torch.cli.mmimdb import batches_on
    from bmnas_tpu_torch.cli.ntu import counts_fn
    from bmnas_tpu_torch.models.ntu import (
        NTU_SEARCH_FROZEN_PREFIXES,
        FoundSkeletonImageNet,
        SearchableSkeletonImageNet,
    )
    from bmnas_tpu_torch.models.supernet import init_arch_params
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    from bmnas_tpu_torch.search.bilevel import (
        TrainState,
        build_step_functions,
        cross_entropy,
        freeze,
        make_arch_optimizer,
        make_weight_optimizer,
    )

    def no_dropout(m):
        for mod in m.modules():  # HCN drops channels with Dropout2d
            if isinstance(mod, (torch.nn.Dropout, torch.nn.Dropout2d)):
                mod.p = 0.0
        return m
    torch.manual_seed(13)
    search = no_dropout(SearchableSkeletonImageNet(**NTU_SEARCH_CFG))
    found = no_dropout(FoundSkeletonImageNet.from_genotype(
        ntu_genotype(), device="cpu", **NTU_CFG))
    arch = init_arch_params(torch.Generator().manual_seed(14), 2, 8, 2)
    host = _tiny_ntu_batches(np.random.RandomState(15), NTU_CPU_SAMPLES, 64,
                             4)
    fns = build_step_functions(cross_entropy, counts_fn)
    out = {"search": [], "found": []}
    launched = {"search": [], "found": []}
    for dev in devices:
        train_b, dev_b, found_b, probe = batches_on(torch.device(dev), host)
        net = copy.deepcopy(search).to(dev)
        freeze(net, NTU_SEARCH_FROZEN_PREFIXES)
        a = {k: v.detach().clone().to(dev).requires_grad_()
             for k, v in arch.items()}
        state = TrainState(
            model=net, arch=a,
            opt_w=make_weight_optimizer(net, NTU_SEARCH_FROZEN_PREFIXES,
                                        3e-4),
            opt_arch=make_arch_optimizer(a, 3e-4, 1e-3))
        fns.weight_step(state, train_b, NTU_STEP_ETA)
        fns.arch_step(state, dev_b)
        before = LAUNCHES["node_mixed"]
        with torch.no_grad():
            out["search"].append(net.eval()(probe, a).float().cpu().numpy())
        launched["search"].append(LAUNCHES["node_mixed"] - before)
        del net, state
        net = copy.deepcopy(found).to(dev)
        state = TrainState(model=net, arch=None,
                           opt_w=make_weight_optimizer(net, (), 3e-4),
                           opt_arch=None)
        fns.weight_step(state, found_b, NTU_STEP_ETA)
        before = LAUNCHES["found_cell"]
        with torch.no_grad():
            out["found"].append(net.eval()(probe).float().cpu().numpy())
        launched["found"].append(LAUNCHES["found_cell"] - before)
        del net, state
    cuda = [torch.device(d).type == "cuda" for d in devices]
    want = {"search": [4 if c else 0 for c in cuda],
            "found": [4 if c else 0 for c in cuda]}
    res = {}
    for k in out:
        diff = float(np.abs(out[k][0] - out[k][1]).max())
        res[k] = {"max_abs_diff": diff, "tolerance": 1e-3,
                  "logits_abs_max": float(np.abs(out[k][1]).max()),
                  "launches": launched[k]}
        if not (np.isfinite(out[k][0]).all() and diff <= 1e-3
                and launched[k] == want[k]):
            raise AssertionError(f"NTU {k} steps CUDA vs CPU: {res[k]}")
    return res


def ntu_found_model(eval_dir, remat, device):
    from bmnas_tpu_torch.genotype import load_genotype
    from bmnas_tpu_torch.models.ntu import FoundSkeletonImageNet
    from bmnas_tpu_torch.utils.checkpoint import load_model
    best = os.path.join(eval_dir, "best")
    model = FoundSkeletonImageNet.from_genotype(
        load_genotype(os.path.join(best, "best_test_genotype.pkl")),
        device="cpu", remat=remat, **NTU_CFG)
    model.load_state_dict(load_model(os.path.join(best,
                                                  "best_test_model.pt")))
    return model.to(device)


def ntu_found_step(model, batch, eta=1e-3):
    """One found weight step (every parameter); returns the peak device
    memory it reached, in bytes, with the memory held before it."""
    from bmnas_tpu_torch.cli.ntu import counts_fn
    from bmnas_tpu_torch.search.bilevel import (
        TrainState,
        build_step_functions,
        cross_entropy,
        make_weight_optimizer,
    )
    state = TrainState(model=model, arch=None,
                       opt_w=make_weight_optimizer(model, (), 3e-4),
                       opt_arch=None)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build_step_functions(cross_entropy, counts_fn).weight_step(state, batch,
                                                              eta)
    torch.cuda.synchronize()
    return {"peak_bytes": torch.cuda.max_memory_allocated(),
            "held_before_bytes": held}


def ntu_remat_on_card(eval_dir, data, device):
    """One found weight step at B=8 (8x256x256 clips) from the retrained
    snapshot with and without ``--remat``, the same batch and dropout
    masks, under ``deterministic_algorithms``: parameters and BatchNorm
    statistics within ``NTU_REMAT_TOL``. The first bottleneck's first
    BatchNorm must run twice in the remat step (the backward's rerun: the
    gradient reached the ResNet) and once without. Reports each step's
    peak memory and the ops that ran without a deterministic CUDA kernel
    (not gated)."""
    import warnings
    batch = ntu_first_batch(data, "train_val", device, NTU_REMAT_BATCH,
                            train=True)
    out, sds, runs = {}, {}, {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with deterministic_algorithms():
            for remat in (False, True):
                model = ntu_found_model(eval_dir, remat, device)
                calls = []
                model.rgbnet.cnn.layer1_0.bn1.register_forward_hook(
                    lambda *a: calls.append(None))
                torch.manual_seed(16)  # the same dropout masks
                key = "remat" if remat else "no_remat"
                out[key] = ntu_found_step(model, batch)
                runs[key] = len(calls)
                sds[remat] = {k: v.detach().cpu()
                              for k, v in model.state_dict().items()}
                del model
                torch.cuda.empty_cache()
    nondet = sorted({str(w.message).split(" does not have a deterministic")[0]
                     for w in caught
                     if "does not have a deterministic" in str(w.message)})
    params, buffers = [0.0], [0.0]
    for k, v in sds[False].items():
        if v.is_floating_point():
            (buffers if k.endswith(BUFFER_SUFFIXES) else params).append(
                float((v.double() - sds[True][k].double()).abs().max()))
    res = dict(out, batch=NTU_REMAT_BATCH, block_runs=runs,
               max_abs_diff_params=max(params),
               max_abs_diff_bn_stats=max(buffers), tolerance=NTU_REMAT_TOL,
               ops_without_deterministic_cuda_kernel=nondet)
    if (max(params + buffers) > NTU_REMAT_TOL
            or runs != {"no_remat": 1, "remat": 2}):
        raise AssertionError(f"--remat differs from no remat: {res}")
    return res


def ntu_train_step_times(s_exp, eval_dir, data, device, tmp):
    """Batch 96, 8x256x256 clips: the search's weight, arch and eval step
    (``step_times``, 3 steps a round), then found retraining's weight step
    with ``--remat`` and eval step, with the weight step's peak memory;
    last, a found weight step without remat at B=96, which is expected to
    run out of memory (reported, not gated)."""
    from bmnas_tpu_torch.cli.ntu import counts_fn
    from bmnas_tpu_torch.models.ntu import NTU_SEARCH_FROZEN_PREFIXES
    from bmnas_tpu_torch.search.bilevel import (
        TrainState,
        build_step_functions,
        cross_entropy,
        freeze,
        make_arch_optimizer,
        make_weight_optimizer,
    )
    fns = build_step_functions(cross_entropy, counts_fn)
    model, arch = ntu_search_model(s_exp, device)
    freeze(model, NTU_SEARCH_FROZEN_PREFIXES)
    arch = {k: v.detach().clone().requires_grad_() for k, v in arch.items()}
    state = TrainState(
        model=model, arch=arch,
        opt_w=make_weight_optimizer(model, NTU_SEARCH_FROZEN_PREFIXES, 3e-4),
        opt_arch=make_arch_optimizer(arch, 3e-4, 1e-3))
    tb = ntu_first_batch(data, "train_exp", device, train=True)
    db = ntu_first_batch(data, "dev", device)
    kw = dict(iters=3, rounds=3, trace_iters=2, top=5)
    out = step_times({
        "search weight": lambda: fns.weight_step(state, tb, 1e-3),
        "search arch": lambda: fns.arch_step(state, db),
        "search eval": lambda: fns.eval_step(state, db)}, tmp, **kw)
    del model, arch, state, tb, db
    torch.cuda.empty_cache()
    model = ntu_found_model(eval_dir, True, device)
    state = TrainState(model=model, arch=None,
                       opt_w=make_weight_optimizer(model, (), 3e-4),
                       opt_arch=None)
    fb = ntu_first_batch(data, "train_val", device, train=True)
    eb = ntu_first_batch(data, "test", device)
    out.update(step_times({
        "found weight (--remat)": lambda: fns.weight_step(state, fb, 1e-3),
        "found eval": lambda: fns.eval_step(state, eb)}, tmp, **kw))
    del state
    torch.cuda.empty_cache()
    memory = {"remat_B96": ntu_found_step(model, fb)}
    del model
    torch.cuda.empty_cache()
    model = ntu_found_model(eval_dir, False, device)
    try:
        memory["no_remat_B96"] = ntu_found_step(model, fb)
    except torch.cuda.OutOfMemoryError as e:
        memory["no_remat_B96"] = {"out_of_memory": str(e).splitlines()[0],
                                  "peak_bytes":
                                  torch.cuda.max_memory_allocated()}
    del model
    torch.cuda.empty_cache()
    return out, memory


def ntu_train_phase(root, device):
    """Phase 11. Returns the report and the launch counts of the NTU search
    path (the search and its eval step) and of the found path (found
    retraining on the search's genotype and on phase 10's, and
    test-only)."""
    from bmnas_tpu_torch.genotype import load_genotype
    from bmnas_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    t0 = time.perf_counter()
    data = write_ntu_train_data(root)
    out = {"write_s": time.perf_counter() - t0}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for convs
    reset_launches()
    s_exp, out["search"] = ntu_search_run(root, data)
    out["search"]["eval"] = ntu_search_eval(s_exp, data, device)
    search_launches = dict(LAUNCHES)
    log("  search: {:.1f} s, best dev acc {:.4f}, node_mixed launches: {} "
        "in the loop, {} in the eval step on a dev batch of {}".format(
            out["search"]["seconds"], out["search"]["best_dev_acc"],
            out["search"]["node_mixed_launches_in_loop"],
            out["search"]["eval"]["launches"], NTU_BATCH))
    test_batches = ntu_split_batches(data, "test")
    reset_launches()
    # found retraining on the search's genotype, then on phase 10's, which
    # reads video inputs; the later checks use the second
    for key, exp in (("found_on_search", s_exp),
                     ("found", write_ntu_found_exp(root))):
        geno = load_genotype(os.path.join(exp, "best", "best_genotype.pkl"))
        cells = len(geno.edges) // 2
        eval_dir, out[key] = ntu_found_run(exp, data, cells, test_batches)
        out[key]["genotype"] = str(geno)
        log("  {} (--remat): {:.1f} s, best test acc {:.4f}, found_cell "
            "launches per phase {} ({} cells, {} test batches), video "
            "inputs read {}".format(
                key, out[key]["seconds"], out[key]["best_test_acc"],
                out[key]["found_cell_launches_per_phase"], cells,
                test_batches, sorted({i for _, i in geno.edges if i < 4})))
    out["found"]["test_only"] = ntu_test_only(eval_dir, data, cells,
                                              test_batches)
    found_launches = dict(LAUNCHES)
    log("  test-only: acc {:.6f} with {} launches".format(
        out["found"]["test_only"]["acc"],
        out["found"]["test_only"]["launches"]))
    out["found"]["serve"] = ntu_serve_eval_dir(eval_dir, data, cells,
                                               test_batches)
    log("  serve on the eval dir: accuracy {:.6f} (test-only {:.6f}), {} "
        "found_cell launches".format(out["found"]["serve"]["value"],
                                     out["found"]["test_only"]["acc"],
                                     out["found"]["serve"]["launches"]))
    torch.backends.cudnn.allow_tf32 = False
    out["steps_cuda_vs_cpu"] = ntu_steps_cuda_vs_cpu()
    log(f"  NTU steps cuda vs cpu: {out['steps_cuda_vs_cpu']}")
    torch.backends.cudnn.allow_tf32 = True
    out["remat"] = ntu_remat_on_card(eval_dir, data, device)
    log("  remat vs no remat (B={batch}, deterministic): first block's bn1 "
        "runs {block_runs}, max diff parameters "
        "{max_abs_diff_params:.3g}, BatchNorm statistics "
        "{max_abs_diff_bn_stats:.3g} (tolerance {tolerance}); peak memory "
        "{p0:.2f} GB without remat, {p1:.2f} GB with; ops without a "
        "deterministic CUDA kernel {ops_without_deterministic_cuda_kernel}"
        .format(p0=out["remat"]["no_remat"]["peak_bytes"] / 1e9,
                p1=out["remat"]["remat"]["peak_bytes"] / 1e9,
                **out["remat"]))
    out["steps"], out["memory_B96"] = ntu_train_step_times(
        s_exp, eval_dir, data, device, root)
    for k, v in out["steps"].items():
        log(f"  {k} (B={NTU_BATCH}, 8x{NTU_HW}x{NTU_HW}): {step_line(v)}")
    log("  found weight step peak memory at B={}: {}".format(
        NTU_BATCH,
        {k: (v["peak_bytes"] / 1e9, v.get("out_of_memory", "ran"))
         for k, v in out["memory_B96"].items()}))
    out["seconds"] = time.perf_counter() - t0
    return out, search_launches, found_launches


# ---------------------------------------------------------------------------
# phase 12: Ego serve
# ---------------------------------------------------------------------------

# the Ego found defaults (cli/ego.py::parse_found_args)
EGO_CFG = dict(C=EGO_C, L=EGO_L, steps=2, multiplier=2, node_steps=3,
               node_multiplier=3, num_input_nodes=8, num_keep_edges=2,
               num_outputs=83, drpt=0.0)
# 100 test gestures (a full batch of 96 and one of 4 padded to 96), clips
# of 32 frames of 320x240 (the corpus's size), twelve gestures to a video
# of 96 frames, their segments overlapping, as in the corpus; the clips
# are centre-cropped to 32 frames of 112x112
EGO_SAMPLES, EGO_BATCH, EGO_FRAMES, EGO_FRAME_WH = 100, 96, 32, (320, 240)
EGO_SIZE = 112
EGO_CPU_SAMPLES = 2  # the CUDA vs CPU batch, at the full width


def ego_genotype():
    """The two cells of ``EGO_KERNEL_CONFIGS`` that phase 12 serves: three
    chained inner steps (each reads the one before it), every inner op
    between them, inner concat of all three (multiplier 3, so each runs
    the out-conv). The first reads the RGB net's x3 and the depth net's
    x4, the second the first cell's output and the depth net's x2."""
    from bmnas_tpu_torch.genotype import Genotype, StepGenotype
    return Genotype(
        edges=[("skip", 1), ("skip", 6), ("skip", 8), ("skip", 4)],
        concat=[8, 9],
        steps=[StepGenotype(list(chain_edges(3)), list(ops), [2, 3, 4])
               for _, _, ops in EGO_KERNEL_CONFIGS[:2]])


def seeded_ego_net(seed, device):
    """The Ego genotype's found net at the full width, made on the CPU:
    convolutions He-initialised, BatchNorm affines randomized, then every
    BatchNorm's statistics taken from one train-mode pass (on ``device``)
    over 4 random clips, the backbones' too (which the net otherwise keeps
    in eval mode): random, so that folding is exercised, and true to the
    activations, so that those stay O(1) through the 33 bottlenecks of
    each ResNeXt-101."""
    from bmnas_tpu_torch.models.ego import FoundRGBDepthNet
    torch.manual_seed(seed)
    model = FoundRGBDepthNet.from_genotype(ego_genotype(), device="cpu",
                                           **EGO_CFG)
    gen = torch.Generator().manual_seed(seed + 1)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm1d)]
    shape = (4, EGO_FRAMES, EGO_SIZE, EGO_SIZE)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.Conv3d):
                fan_in = mod.weight[0].numel()
                mod.weight.normal_(0.0, math.sqrt(2.0 / fan_in),
                                   generator=gen)
        for bn in bns:
            bn.weight.uniform_(0.5, 1.5, generator=gen)
            bn.bias.normal_(0.0, 0.1, generator=gen)
            bn.momentum = 1.0  # the running statistics become the batch's
        batch = {"rgb": torch.randint(0, 256, shape + (3,), generator=gen,
                                      dtype=torch.uint8),
                 "depth": torch.randint(0, 256, shape + (1,), generator=gen,
                                        dtype=torch.uint8),
                 "mask": torch.ones(shape[0])}
        model.to(device).train()
        model.rgb_net.train()
        model.depth_net.train()
        model({k: v.to(device) for k, v in batch.items()})
        for bn in bns:
            bn.momentum = 0.1
    return model.cpu().eval()


def write_ego_experiment(root, device):
    """A synthetic Ego test split (JPEG frames, the annotation) and a found
    experiment dir."""
    from bmnas_tpu_torch.data.synthetic import make_ego_synthetic
    from bmnas_tpu_torch.genotype import save_genotype
    from bmnas_tpu_torch.utils.checkpoint import save_model
    data = os.path.join(root, "ego_data")
    make_ego_synthetic(
        data, num_classes=EGO_CFG["num_outputs"], frames=EGO_FRAMES, seed=0,
        counts={"training": 0, "validation": 0, "testing": EGO_SAMPLES},
        gestures_per_video=12, frame_wh=EGO_FRAME_WH, smooth=True)
    best = os.path.join(root, "ego_exp", "best")
    os.makedirs(best)
    save_genotype(ego_genotype(), os.path.join(best, "best_genotype.pkl"))
    save_model(os.path.join(best, "best_model.pt"),
               seeded_ego_net(0, device))
    return data, os.path.join(root, "ego_exp")


def ego_decoders(root):
    """Which JPEG decoder is installed, and the route ``data.ego._load_jpg``
    takes for a colour, a gray and a colour-encoded gray frame (320x240,
    written by PIL): the decoders it calls (``cv2.imread`` and PIL's
    ``Image.open`` spied on), each frame decoded to its expected shape."""
    from PIL import Image

    from bmnas_tpu_torch.data import ego as ego_data
    out = {}
    for mod in ("cv2", "PIL"):
        try:
            out[mod] = __import__(mod).__version__
        except ImportError:
            out[mod] = None
    called = []
    spied = [(Image, "open", "PIL")]
    if out["cv2"] is not None:
        spied.append((__import__("cv2"), "imread", "cv2"))
    originals = [getattr(mod, name) for mod, name, _ in spied]

    def spy(orig, tag):
        def call(*a, **k):
            called.append(tag)
            return orig(*a, **k)
        return call
    rng = np.random.RandomState(0)
    w, h = EGO_FRAME_WH
    routes = {}
    frames = (("colour", rng.randint(0, 256, (h, w, 3)), False),
              ("gray", rng.randint(0, 256, (h, w)), True),
              ("colour-encoded gray", rng.randint(0, 256, (h, w, 3)), True))
    paths = [os.path.join(root, kind.replace(" ", "_") + ".jpg")
             for kind, _, _ in frames]
    for path, (_, arr, _) in zip(paths, frames):
        Image.fromarray(arr.astype(np.uint8)).save(path)
    try:
        for (mod, name, tag), orig in zip(spied, originals):
            setattr(mod, name, spy(orig, tag))
        for path, (kind, _, gray) in zip(paths, frames):
            called.clear()
            img = ego_data._load_jpg(path, gray)
            if img.shape != (h, w, 1 if gray else 3) or img.dtype != np.uint8:
                raise AssertionError(f"{kind} frame decoded to {img.shape} "
                                     f"{img.dtype}")
            routes[kind] = " then ".join(called)
    finally:
        for (mod, name, _), orig in zip(spied, originals):
            setattr(mod, name, orig)
    out["routes"] = routes
    return out


def ego_args(data, exp):
    """The serve CLI's flags: the data, and the Ego defaults spelt out."""
    return ["--task", "ego", "--eval_exp_dir", exp, "--datadir", data,
            "--checkpointdir", data, "--annotation", "annotation.json",
            "--batchsize", str(EGO_BATCH), "--sample_size", str(EGO_SIZE),
            "--sample_duration", str(EGO_FRAMES), "--num_workers", "8"]


def ego_serve_once(data, exp, bf16):
    """``main_serve --task ego`` at the Ego defaults; 2 found-cell launches
    a batch (one a found cell)."""
    from bmnas_tpu_torch.cli.serve import main_serve
    from bmnas_tpu_torch.ops.kernels import LAUNCHES
    before = LAUNCHES["found_cell"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main_serve(ego_args(data, exp) + (["--bf16"] if bf16
                                                   else []))
    printed = buf.getvalue()
    sys.stdout.write(printed)
    launched = LAUNCHES["found_cell"] - before
    line = json.loads(printed.strip().splitlines()[-1])
    n_batches = -(-EGO_SAMPLES // EGO_BATCH)
    checks = {
        "printed == returned": line == result,
        "metric": result["metric"] == "accuracy",
        "samples": result["samples"] == EGO_SAMPLES,
        "batches": result["batches"] == n_batches,
        "launches == 2 x batches": launched == 2 * n_batches,
        "finite logits": result["logits_finite"],
        "accuracy in [0, 1]": 0.0 <= result["value"] <= 1.0,
    }
    if not all(checks.values()):
        raise AssertionError(f"Ego serve (bf16={bf16}) failed {checks}: "
                             f"{result}, launches={launched}")
    return dict(result, launches=launched)


def ego_server(exp, device, dtype=torch.float32):
    from bmnas_tpu_torch.genotype import load_genotype
    from bmnas_tpu_torch.models.ego import FoundRGBDepthNet
    from bmnas_tpu_torch.serving import load_server
    geno = load_genotype(os.path.join(exp, "best", "best_genotype.pkl"))
    model = FoundRGBDepthNet.from_genotype(geno, device=device, **EGO_CFG)
    return load_server(os.path.join(exp, "best", "best_model.pt"), model,
                       dtype=dtype, device=device)


def ego_dataset(data):
    from bmnas_tpu_torch.data.ego import EgoDataset
    return EgoDataset(data, os.path.join(data, "annotation.json"), "testing",
                      sample_size=EGO_SIZE, sample_duration=EGO_FRAMES,
                      num_workers=8)


def ego_cuda_vs_cpu(data, exp):
    """The first 2 test samples' logits at the full width: the port on CUDA
    (through the kernel) against the port on the CPU (plain PyTorch), TF32
    off on both sides, within 1e-3; and the CUDA server in bf16 against it
    in fp32 (``bf16_vs_fp32``)."""
    batch = next(iter(ego_dataset(data).batches(EGO_CPU_SAMPLES,
                                                shuffle=False)))
    out = {dev: ego_server(exp, dev).predict(batch)
           for dev in ("cuda", "cpu")}
    diff = float(np.abs(out["cuda"] - out["cpu"]).max())
    if not (np.isfinite(out["cuda"]).all() and diff <= 1e-3):
        raise AssertionError(f"Ego CUDA vs CPU logits differ by {diff}")
    return {"samples": EGO_CPU_SAMPLES, "max_abs_diff": diff,
            "logits_abs_max": float(np.abs(out["cpu"]).max()),
            "tolerance": 1e-3,
            "bf16_vs_fp32": bf16_vs_fp32(
                lambda dt: ego_server(exp, "cuda", dt), batch, out["cuda"],
                ("rgb_net", "depth_net"))}


def ego_breakdown(data, exp, dtype, tmp, iters=5):
    """``request_breakdown`` of a request of 96 at the Ego defaults, a
    profiler trace of 2 more requests (device busy ms, the idle share of
    the median ``predict``, kernel launches, the 8 longest kernels and the
    op that launched each), and the peak device memory of a request."""
    server = ego_server(exp, "cuda", dtype)
    parts = (["rgb_net", "depth_net"]
             + [f"reshape_{i}" for i in server.model.used]
             + ["fusion_net", "central_classifier"])
    dataset = ego_dataset(data)
    out = request_breakdown(server, dataset, EGO_BATCH, parts, iters)
    batch = next(iter(dataset.batches(EGO_BATCH, shuffle=False)))
    busy, launches, top = device_busy_ms(lambda: server.predict(batch), tmp,
                                         iters=2, top=8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    server.predict(batch)
    out.update(device_busy_ms=busy, kernel_launches=launches,
               top_kernels_ms=top, device_idle_share=None if busy is None
               else 1 - busy / out["predict_ms"],
               peak_memory_bytes=torch.cuda.max_memory_allocated(),
               resident_bytes=resident)
    return out


def ego_conv_flop(batch):
    """FLOP of each ResNeXt-101's convolutions on one batch (2 per
    multiply-add; the grouped ones apart), counted by forward hooks on a
    copy on the meta device (no data, no compute)."""
    from bmnas_tpu_torch.models.ego import FoundRGBDepthNet
    model = FoundRGBDepthNet.from_genotype(ego_genotype(), device="meta",
                                           **EGO_CFG).eval()
    flop = {"rgb_net": 0, "depth_net": 0, "grouped": 0}
    for part in ("rgb_net", "depth_net"):
        for mod in model.get_submodule(part).modules():
            if isinstance(mod, torch.nn.Conv3d):
                def count(m, a, o, part=part):
                    f = 2 * o.numel() * m.weight[0].numel()
                    flop[part] += f
                    if m.groups > 1:
                        flop["grouped"] += f
                mod.register_forward_hook(count)
    shape = (batch, EGO_FRAMES, EGO_SIZE, EGO_SIZE)
    with torch.no_grad():
        model({"rgb": torch.zeros(shape + (3,), dtype=torch.uint8,
                                  device="meta"),
               "depth": torch.zeros(shape + (1,), dtype=torch.uint8,
                                    device="meta"),
               "mask": torch.ones(batch, device="meta")})
    return flop


def ego_phase(root, device):
    """Phase 12: the Ego found net served at the Ego defaults. Returns the
    report and the launch counts of the serve runs (the main path)."""
    from bmnas_tpu_torch.ops.kernels import LAUNCHES, reset_launches
    t0 = time.perf_counter()
    out = {"decoders": ego_decoders(root)}
    log("  JPEG decoders: cv2 {cv2}, PIL {PIL}; routes {routes}".format(
        **out["decoders"]))
    data, exp = write_ego_experiment(root, device)
    out["write_s"] = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for convs
    reset_launches()
    out["fp32"] = ego_serve_once(data, exp, bf16=False)
    out["bf16"] = ego_serve_once(data, exp, bf16=True)
    launches = dict(LAUNCHES)
    torch.backends.cudnn.allow_tf32 = False
    out["cuda_vs_cpu"] = ego_cuda_vs_cpu(data, exp)
    log(f"  cuda vs cpu logits: {out['cuda_vs_cpu']}")
    torch.backends.cudnn.allow_tf32 = True
    out["breakdown"] = [ego_breakdown(data, exp, dt, root)
                        for dt in (torch.float32, torch.bfloat16)]
    out["conv_flop_per_batch"] = flop = ego_conv_flop(EGO_BATCH)
    for b in out["breakdown"]:
        convs_ms = (b["layer_device_ms"]["rgb_net"]
                    + b["layer_device_ms"]["depth_net"])
        b["conv_tflop_per_s"] = (
            (flop["rgb_net"] + flop["depth_net"]) / convs_ms / 1e9)
        log("  breakdown {dtype}, batch {batch}: load {load_ms_per_batch:.3f}"
            " ms/batch, predict {predict_ms:.3f} ms (median of {n}), other "
            "{other_ms:.3f} ms, layers (device) ".format(
                n=len(b["predict_ms_all"]), **b) + ", ".join(
                f"{k} {v:.4f}" for k, v in b["layer_device_ms"].items())
            + "; convs {:.3f} TFLOP a batch ({:.3f} grouped) at {:.1f} "
            "TFLOP/s over both backbones' spans; peak memory {:.2f} GB "
            "({:.2f} GB resident before the request)".format(
                (flop["rgb_net"] + flop["depth_net"]) / 1e12,
                flop["grouped"] / 1e12, b["conv_tflop_per_s"],
                b["peak_memory_bytes"] / 1e9, b["resident_bytes"] / 1e9))
        if b["device_busy_ms"] is None:
            log("  trace {dtype}: device busy not measured (no device events "
                "in the profiler trace)".format(**b))
        else:
            log("  trace {dtype}: device busy {device_busy_ms:.3f} ms a "
                "request, idle share {device_idle_share:.3f}, "
                "{kernel_launches:.0f} kernel launches; top ".format(**b)
                + ", ".join(f"{n} ({op}) {d:.3f}"
                            for n, d, op in b["top_kernels_ms"]))
    out["seconds"] = time.perf_counter() - t0
    return out, launches


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="also write the full measurements as JSON here")
    args = ap.parse_args(argv)
    # phase 8 runs cuBLAS deterministically; cuBLAS reads this when CUDA
    # starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs on the GPU only",
              file=sys.stderr)
        return 1
    from bmnas_tpu_torch.ops.kernels import LAUNCHES, _build, reset_launches

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind}")
    report = {"nvidia_smi": smi, "device": kind, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    names = sorted(LAUNCHES)
    _build.build_all(names)
    report["build_s"] = time.perf_counter() - t0
    log(f"[2 build] {names} in {report['build_s']:.1f} s")
    report["ptxas"] = {}
    for n in names:
        for line in _build.build_log(n).splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {n}: {line.strip()}")
                report["ptxas"].setdefault(n, []).append(line.strip())

    log("[3 found_cell vs plain] L=16 C=192; NTU and Ego widths, L=8 "
        "C=128")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = kernel_phase(device)
    report["found_cell"] = rows

    log(f"[4 node_mixed vs plain] L=16 C=192, B in {MIXED_BATCHES}, "
        f"{len(MIXED_GAMMAS)} gamma kinds, x != y and x is y")
    mixed_rows, pairs = mixed_phase(device)
    report["node_mixed"] = mixed_rows
    report["node_mixed_pairs"] = pairs

    log("[5 serve] MM-IMDB found net, C=192 L=16, 160x256 images, "
        f"{SERVE_SAMPLES} samples in batches of {BATCH}")
    main_path_launches = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        data, exp = write_experiment(tmp)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True  # PyTorch's default for convs
        reset_launches()
        serve = {"fp32": serve_once(data, exp, bf16=False),
                 "bf16": serve_once(data, exp, bf16=True)}
        main_path_launches["serve"] = dict(LAUNCHES)
        serve["cuda_vs_cpu"] = cuda_vs_cpu(data, exp)
        log(f"  cuda vs cpu logits: {serve['cuda_vs_cpu']}")
        torch.backends.cudnn.allow_tf32 = True
        serve["breakdown"] = [serve_breakdown(data, exp, dt)
                              for dt in (torch.float32, torch.bfloat16)]
        for b in serve["breakdown"]:
            log("  breakdown {dtype}: load {load_ms_per_batch:.3f} ms/batch,"
                " predict {predict_ms:.3f} ms, other {other_ms:.3f} ms, "
                "layers (device) ".format(**b) + ", ".join(
                    f"{k} {v:.4f}" for k, v in b["layer_device_ms"].items()))
        report["serve"] = serve

        log("[6 search] MM-IMDB supernet, C=192 L=16, 160x256 images, "
            f"{SEARCH_COUNTS['train']} train + {SEARCH_COUNTS['dev']} dev "
            f"samples in batches of {BATCH}, one epoch")
        reset_launches()
        s_exp, s_data, train_launches, best_f1, geno, s_seconds = \
            search_run(tmp)
        search = check_search_artifacts(s_exp, best_f1, geno)
        search["seconds"] = s_seconds
        search["node_mixed_launches_in_train_mode_steps"] = train_launches
        if train_launches != 0:
            raise AssertionError(f"node_mixed launched {train_launches} "
                                 "times during the train-mode steps")
        search["eval"] = search_eval(s_exp, s_data, device)
        main_path_launches["search"] = dict(LAUNCHES)
        log("  search: {:.1f} s, best dev F1 {:.4f}, node_mixed launches: "
            "{} in the train-mode steps, {} in the eval step over {} dev "
            "batches".format(s_seconds, best_f1, train_launches,
                             search["eval"]["launches"],
                             search["eval"]["batches"]))
        torch.backends.cudnn.allow_tf32 = False
        search["cuda_vs_cpu"] = search_cuda_vs_cpu(s_exp, s_data)
        log(f"  eval logits cuda vs cpu: {search['cuda_vs_cpu']}")
        search["steps_cuda_vs_cpu"] = search_steps_cuda_vs_cpu()
        log(f"  3 bilevel steps cuda vs cpu: {search['steps_cuda_vs_cpu']}")
        torch.backends.cudnn.allow_tf32 = True
        search["steps"] = search_step_times(s_exp, s_data, device, tmp)
        for k, v in search["steps"].items():
            log(f"  {k} (B=8, 160x256): {step_line(v)}")
        report["search"] = search

        test_batches = -(-SEARCH_COUNTS["test"] // BATCH)
        log("[7 found] MM-IMDB found net from the search, C=192 L=16, "
            f"160x256 images, {SEARCH_COUNTS['train']} train + "
            f"{SEARCH_COUNTS['dev']} dev + {SEARCH_COUNTS['test']} test "
            f"samples in batches of {BATCH}, one epoch")
        reset_launches()
        eval_dir, f1, per_phase, f_seconds = found_run(s_exp, s_data)
        found = check_found_artifacts(eval_dir, f1, per_phase, test_batches)
        found["seconds"] = f_seconds
        found["test_only"] = test_only(eval_dir, s_data, test_batches)
        main_path_launches["found"] = dict(LAUNCHES)
        log("  found: {:.1f} s, best test F1 {:.4f}, found_cell launches "
            "per phase {}; test-only F1 {:.6f} with {} launches over {} "
            "test batches".format(f_seconds, f1, per_phase,
                                  found["test_only"]["f1"],
                                  found["test_only"]["launches"],
                                  test_batches))
        found["serve"] = serve_eval_dir(eval_dir, s_data)
        log("  serve on the eval dir: weighted F1 {:.6f} (test-only "
            "{:.6f}), {} found_cell launches over {} batches".format(
                found["serve"]["value"], found["test_only"]["f1"],
                found["serve"]["launches"], found["serve"]["batches"]))
        torch.backends.cudnn.allow_tf32 = False
        found["steps_cuda_vs_cpu"] = found_steps_cuda_vs_cpu()
        log(f"  3 found weight steps cuda vs cpu: "
            f"{found['steps_cuda_vs_cpu']}")
        torch.backends.cudnn.allow_tf32 = True
        found["steps"] = found_step_times(eval_dir, s_data, device, tmp)
        for k, v in found["steps"].items():
            log(f"  found {k} (B=8, 160x256): {step_line(v)}")
        report["found"] = found

        log("[8 resume] search and found retraining, C=192 L=16, 160x256 "
            f"images, {RESUME_COUNTS} samples in batches of {BATCH}: 2 "
            "epochs against 1 epoch + --resume, deterministic algorithms")
        report["resume"] = resume_phase(tmp, s_exp)
        for k, v in report["resume"].items():
            log(f"  resume {k}: max diff parameters "
                f"{v['max_abs_diff_params']:.3g}, BatchNorm statistics "
                f"{v['max_abs_diff_bn_stats']:.3g}, loss "
                f"{v['max_abs_diff_loss']:.3g}, F1 {v['max_abs_diff_f1']:.3g}"
                f" (tolerance {v['tolerance']}; the loss moved "
                f"{v['loss_change_epoch0_to_1']:.3g} from epoch 0 to 1), "
                f"rng states equal {v['rng_states_equal']}, ops without a "
                f"deterministic CUDA kernel "
                f"{v['ops_without_deterministic_cuda_kernel']}")
        # found retraining back-propagates through both reshape layers'
        # pools into the backbones: no op there may add in no fixed order
        nondet = report["resume"]["found"][
            "ops_without_deterministic_cuda_kernel"]
        if nondet:
            raise AssertionError(f"resume found: ops without a "
                                 f"deterministic CUDA kernel ran: {nondet}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    log("[9 attention vs plain] fp32 and bf16 inputs, "
        f"{len(ATTN_CASES)} shapes; times at B=8 C=192 L in {ATTN_TIMED}")
    reset_launches()
    attn_rows = attention_phase(device)
    report["attention"] = attn_rows
    report["attention_memory"] = attention_memory(device)
    main_path_launches["attention"] = dict(LAUNCHES)
    log(f"  attention memory: {report['attention_memory']}")
    report["attention_times"] = attn_times = attention_times(device)
    report["attention_sweep"] = attention_sweep(device)
    report["attention_ablation"] = attention_ablation(device)

    log("[10 NTU serve] NTU found net, C={C} L={L} steps {steps} "
        "node_steps {node_steps} node_multiplier {node_multiplier}, 8x{hw}x"
        "{hw} clips and 32-frame skeletons, {n} samples in batches of {b}"
        .format(hw=NTU_HW, n=NTU_SAMPLES, b=NTU_BATCH, **NTU_CFG))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ntu_")
    try:
        report["ntu_serve"], main_path_launches["ntu serve"] = ntu_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("  NTU serve: {:.1f} s (writing the data {:.1f} s); found_cell "
        "launches fp32 {}, bf16 {} over {} batches each".format(
            report["ntu_serve"]["seconds"], report["ntu_serve"]["write_s"],
            report["ntu_serve"]["fp32"]["launches"],
            report["ntu_serve"]["bf16"]["launches"],
            report["ntu_serve"]["fp32"]["batches"]))

    log("[11 NTU search and found retraining] the NTU search defaults "
        "(steps 2, batch {b}) then found retraining at the found defaults "
        "with --remat, the full inflated 3D ResNet-50 and HCN, {n} clips of "
        "{f}x{hw}x{hw} a subject of {s}, one epoch each".format(
            b=NTU_BATCH, n=NTU_TRAIN_PER_SUBJECT, f=NTU_TRAIN_FRAMES,
            hw=NTU_HW, s=NTU_TRAIN_SUBJECTS))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ntu_train_")
    try:
        (report["ntu_train"], main_path_launches["ntu search"],
         main_path_launches["ntu found"]) = ntu_train_phase(tmp, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("  NTU search and found retraining: {:.1f} s (writing the data "
        "{:.1f} s)".format(report["ntu_train"]["seconds"],
                           report["ntu_train"]["write_s"]))

    log("[12 Ego serve] Ego found net, C={C} L={L} steps {steps} "
        "node_steps {node_steps} node_multiplier {node_multiplier}, two "
        "ResNeXt-101s, {f}-frame clips of {w}x{h} JPEG frames cropped to "
        "{s}x{s}, {n} samples in batches of {b}".format(
            f=EGO_FRAMES, w=EGO_FRAME_WH[0], h=EGO_FRAME_WH[1], s=EGO_SIZE,
            n=EGO_SAMPLES, b=EGO_BATCH, **EGO_CFG))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ego_")
    try:
        report["ego_serve"], main_path_launches["ego serve"] = ego_phase(
            tmp, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("  Ego serve: {:.1f} s (writing the data and the snapshot {:.1f} s);"
        " found_cell launches fp32 {}, bf16 {} over {} batches each".format(
            report["ego_serve"]["seconds"], report["ego_serve"]["write_s"],
            report["ego_serve"]["fp32"]["launches"],
            report["ego_serve"]["bf16"]["launches"],
            report["ego_serve"]["fp32"]["batches"]))

    report["main_path_launches"] = main_path_launches
    for path, name in (("serve", "found_cell"), ("found", "found_cell"),
                       ("search", "node_mixed"), ("attention", "attention"),
                       ("ntu serve", "found_cell"),
                       ("ntu search", "node_mixed"),
                       ("ntu found", "found_cell"),
                       ("ego serve", "found_cell")):
        if main_path_launches[path][name] == 0:
            raise AssertionError(f"kernel {name} never launched on its main "
                                 f"path ({path})")

    # the kernels line. found_cell: the served genotype's two cells at B=8,
    # fp32; node_mixed: the supernet's call (x is y, softmaxed gammas) at
    # B=8, fp32
    served = [r for r in rows if r["B"] == 8 and r["dtype"] == "float32"
              and r["C"] == C and r["node_steps"] == 1
              and r["ops"] in ("ScaleDotAttn", "LinearGLU")]
    # the NTU genotype's four cells (two steps) and the Ego cells (three)
    # at the serving batch, fp32
    ntu_cells = [r for r in rows if r["C"] == NTU_C and r["B"] == NTU_BATCH
                 and r["node_steps"] == 2 and r["dtype"] == "float32"]
    ego_cells = [r for r in rows if r["C"] == EGO_C and r["B"] == EGO_BATCH
                 and r["node_steps"] == 3 and r["dtype"] == "float32"]
    mean = lambda k: sum(r[k] for r in served) / len(served)  # noqa: E731
    err = lambda rs, dt: max(r["max_abs_err"] for r in rs  # noqa: E731
                             if r["dtype"] == dt)
    (mixed,) = [r for r in mixed_rows if "ms" in r and r["B"] == 8
                and r["C"] == C and r["dtype"] == "float32"]
    (mixed_ntu,) = [r for r in mixed_rows if "ms" in r and r["C"] == NTU_C
                    and r["dtype"] == "float32"]
    launches = {p: main_path_launches[p]
                for p in ("serve", "found", "ntu serve", "ntu found",
                          "ego serve")}
    attn512 = attn_times[512]
    kernels = {"kernels": [{
        "name": "found_cell",
        "route": "cuda",
        "source": "bmnas_tpu_torch/csrc/found_cell.cu",
        "replaces": "bmnas_tpu/ops/kernels/node_mixed.py:368",
        "launches": sum(v["found_cell"] for v in launches.values()),
        "launches_by_path": {
            "serve": launches["serve"]["found_cell"],
            "found test phase and test-only":
            launches["found"]["found_cell"],
            "ntu serve": launches["ntu serve"]["found_cell"],
            "ntu found test phase and test-only":
            launches["ntu found"]["found_cell"],
            "ego serve": launches["ego serve"]["found_cell"]},
        "max_abs_err": err(rows, "float32"),
        "max_abs_err_bf16": err(rows, "bfloat16"),
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": ("bytes" if all(r["bound_by"] == "bytes" for r in served)
                     else "operations"),
        "library_ms": None,
        "call_ms": mean("call_ms"),
        "plain_call_ms": mean("plain_call_ms"),
        "ntu_width_B96": {k: sum(r[k] for r in ntu_cells) / len(ntu_cells)
                          for k in ("ms", "plain_ms", "bound_ms",
                                    "tc_bound_ms")},
        "ego_width_B96": {k: sum(r[k] for r in ego_cells) / len(ego_cells)
                          for k in ("ms", "alt_ms", "plain_ms", "bound_ms",
                                    "tc_bound_ms")},
    }, {
        "name": "node_mixed",
        "route": "cuda",
        "source": "bmnas_tpu_torch/csrc/node_mixed.cu",
        "replaces": "bmnas_tpu/ops/kernels/node_mixed.py:201",
        "launches": (main_path_launches["search"]["node_mixed"]
                     + main_path_launches["ntu search"]["node_mixed"]),
        "launches_by_path": {
            "search eval step": main_path_launches["search"]["node_mixed"],
            "ntu search eval step":
            main_path_launches["ntu search"]["node_mixed"]},
        "max_abs_err": err(mixed_rows, "float32"),
        "max_abs_err_bf16": err(mixed_rows, "bfloat16"),
        "ms": mixed["ms"],
        "plain_ms": mixed["plain_ms"],
        "bound_ms": mixed["bound_ms"],
        "bound_by": mixed["bound_by"],
        "library_ms": None,
        "tc_bound_ms": mixed["tc_bound_ms"],
        "geometry": mixed["geometry"],
        "call_ms": mixed["call_ms"],
        "plain_call_ms": mixed["plain_call_ms"],
        "ntu_width_B96": {k: mixed_ntu[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "tc_bound_ms",
            "geometry")},
    }, {
        "name": "attention",
        "route": "cuda",
        "source": "bmnas_tpu_torch/csrc/attention.cu",
        "replaces": "bmnas_tpu/ops/kernels/attention.py:74",
        "launches": main_path_launches["attention"]["attention"],
        "note": "on no path of the JAX package (only its tests call the TPU "
                "kernel): launches are phase 9's checked calls; times at "
                "B=8, L=512, C=192, fp32",
        "max_abs_err": err(attn_rows, "float32"),
        "max_abs_err_bf16": err(attn_rows, "bfloat16"),
        "ms": attn512["ms"],
        "plain_ms": attn512["plain_ms"],
        "bound_ms": attn512["bound_ms"],
        "bound_by": attn512["bound_by"],
        "library_ms": attn512["library_ms"],
        "ms_over_library": attn512["ms_over_library"],
        "tc_bound_ms": attn512["tc_bound_ms"],
        "geometry": attn512["geometry"],
        "by_L": attn_times,
        "peak_growth_bytes_L8192": report["attention_memory"][
            "peak_growth_bytes"],
    }]}
    report["kernels"] = kernels["kernels"]
    report["seconds"] = time.perf_counter() - t_start
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"[13 result] {report['seconds']:.1f} s"
        + (f"; full report in {args.out}" if args.out else ""))
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
