"""The found-cell kernel (``csrc/found_cell.cu`` with ``cell_whole.cuh``,
``cell_gemm.cuh``, ``tc_gemm.cuh`` and ``cell_common.cuh``) run on the CPU
by emulation (``tests/_kernel_emu.py``), through the port's bindings,
against ``found_node_cell_reference``: every cell configuration, both
designs, the phase plans, batches and 'none' edges, the weight ring, the
launcher's picks, and the C function's refusals. Skips where there is no
``g++``. The NTU and Ego widths and the GEMM geometries are in
``tests/test_torch_port_kernel_emu_found_shapes.py``.
"""
import pytest
import torch

from _kernel_emu import (  # noqa: F401 (fixtures)
    GEOMETRY_CELLS,
    cell_inputs,
    chain,
    compare_found,
    emu_lib,
    emu_libs,
    found_params,
    geometry_case,
    nan_scratch,
)
from bmnas_tpu_torch.ops.kernels import node_mixed as tnm

CONFIGS = [
    (1, 1, ("Sum",)),
    (1, 1, ("ScaleDotAttn",)),
    (1, 1, ("LinearGLU",)),
    (1, 1, ("ConcatFC",)),
    (2, 2, ("ConcatFC", "ScaleDotAttn")),
    (2, 2, ("LinearGLU", "LinearGLU")),
    (3, 1, ("ScaleDotAttn", "Sum", "ConcatFC")),
    (4, 6, ("LinearGLU", "Sum", "ConcatFC", "ScaleDotAttn")),
]
IDS = ["-".join(ops) + f"-m{m}" for _, m, ops in CONFIGS]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("node_steps,m,ops", CONFIGS, ids=IDS)
def test_kernel_matches_reference(emu_lib, node_steps, m, ops, dtype):
    """B=3, L=8, C=16: one row tile, half of it past the last row."""
    B, L, C = 3, 8, 16
    gen = torch.Generator().manual_seed(node_steps * 10 + m)
    cfg = tnm.found_cell_steps_cfg(
        tuple(e for i in range(node_steps)
              for e in (("skip", i), ("skip", i + 1))), ops)
    p = found_params(gen, node_steps, m, L, C, dtype)
    x = torch.randn(B, L, C, generator=gen).to(dtype)
    y = torch.randn(B, L, C, generator=gen).to(dtype)
    compare_found(emu_lib, x, y, p, cfg, m)


def test_kernel_two_row_tiles_and_none_edges(emu_lib):
    """L=20 (a full row tile, then a ragged one), C=32 (several K-tiles),
    and 'none' inner edges, which read zeros."""
    B, L, C = 2, 20, 32
    gen = torch.Generator().manual_seed(11)
    cfg = tnm.found_cell_steps_cfg(
        (("none", 0), ("skip", 1), ("skip", 2), ("none", 0),
         ("skip", 3), ("skip", 0)), ("ScaleDotAttn", "LinearGLU", "ConcatFC"))
    p = found_params(gen, 3, 3, L, C, torch.float32)
    x, y = (torch.randn(B, L, C, generator=gen) for _ in range(2))
    compare_found(emu_lib, x, y, p, cfg, 3)


def test_kernel_refuses_width(emu_lib):
    """The C function itself refuses a width it cannot host, and the
    binding turns its error code into an exception."""
    B, L, C = 2, 8, 12
    gen = torch.Generator().manual_seed(3)
    p = found_params(gen, 1, 1, L, C, torch.float32)
    x = torch.randn(B, L, C, generator=gen)
    with pytest.raises(RuntimeError, match="launch failed"):
        tnm.launch(emu_lib, x, x, p, ((0, (True, 0), (True, 1)),), 1, 1e-5,
                   None)


# (inner ops, multiplier, the phases: one launch each; '*' marks the GEMM
# phase that ends the cell with the residual and the LayerNorm)
PHASE_PLANS = [
    (("Sum",), 1, ("final",)),
    (("ScaleDotAttn",), 1, ("final",)),
    (("LinearGLU",), 1, ("glu*",)),
    (("LinearGLU", "Sum"), 1, ("glu", "final")),
    (("LinearGLU", "LinearGLU"), 2, ("glu", "glu", "out_conv*")),
    (("ScaleDotAttn", "ConcatFC"), 2, ("fc", "out_conv*")),
    (("ConcatFC", "Sum"), 2, ("fc", "out_conv*")),
    (("Sum", "ScaleDotAttn"), 2, ("out_conv*",)),
    (("ScaleDotAttn", "Sum", "ConcatFC"), 1, ("fc*",)),
    (("LinearGLU", "ConcatFC", "LinearGLU"), 2,
     ("glu", "fc", "glu", "out_conv*")),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("ops,m,kinds", PHASE_PLANS,
                         ids=["-".join(o) + f"-m{m}"
                              for o, m, _ in PHASE_PLANS])
def test_kernel_phase_plans(emu_lib, ops, m, kinds, dtype):
    """Every phase plan: one launch (no GEMM and m = 1, or a last GEMM that
    ends the cell), two, three and four (the NTU serving cells' op pairs,
    chained, m = 2; the 3-step ScaleDotAttn+Sum+ConcatFC; a step after the
    last GEMM, which keeps a last phase of its own), the plan the C
    function reports equal to ``found_cell_phases``, against
    ``found_node_cell_reference`` on a NaN scratch. B=3 (the last GEMM
    group ragged at two samples a block), L=8, C=16; the phased design
    asked for (the launcher runs a cell without a GEMM in one block a
    sample)."""
    B, L, C = 3, 8, 16
    cfg = chain(ops)
    itemsize = 4 if dtype == torch.float32 else 2
    geom = tnm.found_cell_geometry(emu_lib, B, L, C, cfg, m, itemsize,
                                   design="phases")
    mark = lambda ph: ph["kind"] + "*" * ph["fused"]  # noqa: E731
    assert tuple(mark(g) for g in geom) == kinds
    assert tuple(mark(p) for p in tnm.found_cell_phases(cfg, m)) == kinds
    assert [g["threads"] for g in geom] == [
        256 if k == "final" else 512 for k in kinds]
    gen = torch.Generator().manual_seed(len(ops) * 10 + m)
    p, x, y = cell_inputs(gen, B, L, C, len(ops), m, dtype)
    compare_found(emu_lib, x, y, p, cfg, m, design="phases")


# inner edges with 'none' (zeros) in an attention and in a GEMM, read in
# the phase that computes them, in a later GEMM phase and in the last phase
NONE_EDGE_CELLS = {
    "attn-glu-fc-m3": (
        (("none", 0), ("skip", 1), ("skip", 2), ("none", 0),
         ("skip", 3), ("skip", 0)),
        ("ScaleDotAttn", "LinearGLU", "ConcatFC"), 3),
    "glu-attn-sum-m1": (
        (("skip", 0), ("none", 1), ("skip", 2), ("none", 0),
         ("none", 1), ("skip", 3)),
        ("LinearGLU", "ScaleDotAttn", "Sum"), 1),
}


@pytest.mark.parametrize("B", [1, 2, 37])
@pytest.mark.parametrize("cell", list(NONE_EDGE_CELLS))
def test_kernel_batches_and_none_edges(emu_lib, cell, B):
    """B of one sample, two, and 37 (ten groups of four samples the last of
    one, at L=8), with 'none' edges: an attention over zero queries inside
    a GEMM phase, a GEMM half of zeros, and an attention over zero values
    and a Sum in the last phase; on a NaN scratch, in fp32, and in bf16 at
    B=1 and 2."""
    L, C = 8, 16
    edges, ops, m = NONE_EDGE_CELLS[cell]
    cfg = tnm.found_cell_steps_cfg(edges, ops)
    for dtype in (torch.float32, torch.bfloat16)[:2 if B <= 2 else 1]:
        gen = torch.Generator().manual_seed(B)
        p, x, y = cell_inputs(gen, B, L, C, len(ops), m, dtype)
        compare_found(emu_lib, x, y, p, cfg, m)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_weight_ring(emu_lib, dtype):
    """A cell of every step kind whose 6-way out-conv (528 rows deep at
    C=88) takes the weights through a ring of K-tiles, one sample and 16
    columns a block."""
    geometry_case(emu_lib, "four-phases-ring", 1, 16, dtype)


@pytest.mark.parametrize("L,C,B,ops,m,picks", [
    (16, 192, 8, ("LinearGLU",), 1, [("glu", 1, 16, 96)]),
    (16, 192, 37, ("LinearGLU",), 1, [("glu", 2, 32, 114)]),
    (16, 192, 96, ("LinearGLU",), 1, [("whole", 1, 192, 96)]),
    (16, 192, 96, ("ConcatFC",), 1, [("whole", 1, 192, 96)]),
    (16, 192, 8, ("LinearGLU", "Sum"), 1, [("glu", 1, 16, 96),
                                           ("final", 1, 192, 8)]),
    (8, 128, 8, ("LinearGLU", "LinearGLU"), 2,
     [("glu", 1, 16, 64)] * 2 + [("out_conv", 1, 16, 64)]),
    (8, 128, 96, ("LinearGLU", "LinearGLU"), 2, [("whole", 1, 128, 96)]),
    (8, 128, 96, ("Sum", "ScaleDotAttn"), 2, [("whole", 1, 128, 96)]),
], ids=["mmimdb-glu-B8", "mmimdb-glu-B37", "mmimdb-glu-B96",
        "mmimdb-fc-B96", "mmimdb-glu-sum-B8", "ntu-glu-B8", "ntu-glu-B96",
        "ntu-sum-attn-B96"])
def test_found_launcher_fills_the_card(emu_lib, L, C, B, ops, m, picks):
    """At the MM-IMDB (L=16, C=192) and NTU (L=8, C=128) widths the
    launcher fills the card's 132 SMs: at B=8 and 37 it spreads each GEMM
    phase over them (one 512-thread block an SM; one sample and 16 columns
    a block at B=8, 96 and 64 blocks; two samples and 32 columns at B=37),
    a last phase of its own (a step after the last GEMM) a sample a block;
    at B=96, where B blocks fill more than half of them, it runs the whole
    cell in one block a sample. In fp32 and bf16, within the shared memory
    a block may take."""
    cfg = chain(ops)
    for itemsize in (4, 2):
        geom = tnm.found_cell_geometry(emu_lib, B, L, C, cfg, m, itemsize)
        assert [(g["kind"], g["samples_per_block"], g["cols_per_block"],
                 g["blocks"]) for g in geom] == picks
        assert all(g["smem_bytes"] <= tnm.SMEM_LIMIT for g in geom)


# (inner ops, multiplier, B, design asked for, the design the call takes)
DESIGN_PICKS = [
    (("LinearGLU",), 1, 65, "auto", "phases"),
    (("LinearGLU",), 1, 66, "auto", "whole"),
    (("Sum", "ScaleDotAttn"), 2, 65, "auto", "phases"),
    (("Sum", "ScaleDotAttn"), 2, 66, "auto", "whole"),
    (("Sum",), 1, 1, "auto", "whole"),
    (("Sum", "Sum"), 1, 8, "auto", "whole"),
    (("ScaleDotAttn",), 1, 1, "auto", "whole"),
    (("Sum", "ScaleDotAttn"), 1, 96, "auto", "whole"),
    (("LinearGLU",), 1, 8, "whole", "whole"),
    (("LinearGLU",), 1, 96, "phases", "phases"),
]


@pytest.mark.parametrize("ops,m,B,design,want", DESIGN_PICKS,
                         ids=[f"{'-'.join(o)}-m{m}-B{B}-{d}"
                              for o, m, B, d, _ in DESIGN_PICKS])
def test_found_launcher_picks_the_design(emu_lib, ops, m, B, design, want):
    """On 132 SMs at L=8, C=128 the launcher runs a cell with a GEMM step
    or an out-conv as phases up to B=65 and in one block a sample from
    B=66 (half the SMs), a cell without a GEMM (Sums, attentions) in one
    block a sample at any B; a design asked for is the one taken, and a
    fixed GEMM geometry asks for the phases."""
    cfg = chain(ops)
    geom = tnm.found_cell_geometry(emu_lib, B, 8, 128, cfg, m, 4,
                                   design=design)
    got = "whole" if [g["kind"] for g in geom] == ["whole"] else "phases"
    assert got == want
    if want == "whole":
        (g,) = geom
        assert (g["samples_per_block"], g["blocks"], g["threads"]) == (
            1, B, 256)
    if want == "whole" and design == "auto":
        fixed = tnm.found_cell_geometry(emu_lib, B, 8, 128, cfg, m, 4,
                                        samples_per_block=2)
        assert all(g["kind"] != "whole" for g in fixed)


# (inner ops, multiplier, B, L, C): the whole cell in one block a sample,
# asked for: every phase-plan cell at B=3 (a block of 64 threads), a ring
# of K-tiles deeper than the double buffer (C=88: 2C = 176 rows of 32), and
# two row tiles, the second ragged (L=20)
WHOLE_CELLS = [(o, m, 3, 8, 16) for o, m, _ in PHASE_PLANS] + [
    (("LinearGLU", "Sum", "ConcatFC", "ScaleDotAttn"), 6, 2, 8, 88),
    (("ConcatFC", "ScaleDotAttn"), 2, 2, 20, 32),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("ops,m,B,L,C", WHOLE_CELLS,
                         ids=[f"{'-'.join(o)}-m{m}-L{L}-C{C}"
                              for o, m, _, L, C in WHOLE_CELLS])
def test_kernel_whole_design(emu_lib, ops, m, B, L, C, dtype):
    """The whole cell in one block a sample against
    ``found_node_cell_reference`` on a NaN scratch, which it never
    reads."""
    cfg = chain(ops)
    itemsize = 4 if dtype == torch.float32 else 2
    (g,) = tnm.found_cell_geometry(emu_lib, B, L, C, cfg, m, itemsize,
                                   design="whole")
    assert (g["kind"], g["blocks"], g["threads"]) == (
        "whole", B, 2 * -(-C // 32) * 32)
    gen = torch.Generator().manual_seed(len(ops) * 10 + m + L)
    p, x, y = cell_inputs(gen, B, L, C, len(ops), m, dtype)
    compare_found(emu_lib, x, y, p, cfg, m, design="whole")


def test_kernel_whole_design_none_edges(emu_lib):
    """The whole cell in one block a sample with 'none' inner edges in an
    attention, a GEMM and a Sum, at B=37."""
    L, C = 8, 16
    for edges, ops, m in NONE_EDGE_CELLS.values():
        cfg = tnm.found_cell_steps_cfg(edges, ops)
        gen = torch.Generator().manual_seed(37)
        p, x, y = cell_inputs(gen, 37, L, C, len(ops), m, torch.float32)
        compare_found(emu_lib, x, y, p, cfg, m, design="whole")


def test_kernel_tickets_return_to_zero(emu_lib):
    """A phase that ends the cell takes a ticket a sample group; the last
    block of each group leaves it at 0, so one buffer serves call after
    call, and the same input gives the same output bit for bit."""
    B, L, C = 3, 8, 24
    cfg = chain(("ConcatFC", "LinearGLU"))
    gen = torch.Generator().manual_seed(21)
    p, x, y = cell_inputs(gen, B, L, C, 2, 2, torch.float32)
    tickets = torch.zeros(B, dtype=torch.int32)
    outs = []
    for S, nt in [(2, 16), (1, 16), (2, 16)]:
        outs.append(tnm.launch(emu_lib, x, y, p, cfg, 2, 1e-5, None,
                               nan_scratch(x, cfg), S, nt, tickets))
        assert not tickets.any()
    assert torch.equal(outs[0], outs[2])
    want = tnm.found_node_cell_reference(x, y, p, cfg, 2)
    for got in outs:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_smem_bytes_match_the_kernel(emu_lib):
    """``found_cell_smem_bytes`` in Python (what the blocker reads) equals
    the C function for every cell of these tests, both storage types and
    several widths and lengths."""
    cells = [(chain(o), m) for _, m, o in CONFIGS]
    cells += [(chain(o), m) for o, m, _ in PHASE_PLANS]
    cells += [(chain(o), m) for o, m, _ in GEOMETRY_CELLS.values()]
    cells += [(tnm.found_cell_steps_cfg(e, o), m)
              for e, o, m in NONE_EDGE_CELLS.values()]
    for cfg, m in cells:
        for L, C in [(8, 16), (16, 192), (8, 128), (20, 88), (64, 256)]:
            for itemsize in (4, 2):
                want = emu_lib.found_cell_smem_bytes(
                    L, C, len(cfg), m, *tnm._steps_arrays(cfg), itemsize)
                assert tnm.found_cell_smem_bytes(
                    L, C, cfg, m, itemsize) == want, (cfg, m, L, C)


def test_kernel_refuses_geometry(emu_lib):
    """Three samples a block is refused by the C function; a cell longer
    than a GEMM block's rows is refused by the binding."""
    gen = torch.Generator().manual_seed(9)
    cfg = chain(("LinearGLU",))
    p, x, y = cell_inputs(gen, 4, 8, 16, 1, 1, torch.float32)
    with pytest.raises(RuntimeError, match="launch failed"):
        tnm.launch(emu_lib, x, y, p, cfg, 1, 1e-5, None,
                   samples_per_block=3)
    L = tnm.FOUND_MAX_L + 1
    p, x, y = cell_inputs(gen, 1, L, 8, 1, 1, torch.float32)
    with pytest.raises(ValueError, match="cannot host"):
        tnm.launch(emu_lib, x, y, p, cfg, 1, 1e-5, None)
