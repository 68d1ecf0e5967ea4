"""The supernet's mixed-op kernel (``csrc/node_mixed.cu`` with
``cell_gemm.cuh``, ``tc_gemm.cuh`` and ``cell_common.cuh``) run on the CPU
by emulation (``tests/_kernel_emu.py``), through the port's bindings,
against ``node_mixed_op_reference``: every branch weighting, x and y two
tensors or one, the geometries, the launcher's picks and the C
function's refusals. Skips where there is no ``g++``.
"""
import math

import pytest
import torch

from _kernel_emu import TOLS, emu_libs  # noqa: F401 (fixture)
from bmnas_tpu_torch.ops.kernels import node_mixed as tnm

def _mixed_params(gen, L, C, dtype):
    def r(*shape, k=1.0):
        return (torch.randn(*shape, generator=gen) * k).to(dtype)
    w = 1.0 / math.sqrt(2 * C)
    return tnm.NodeMixedParams(
        ln_scale=r(L, C), ln_bias=r(L, C),
        glu_kernel=r(2 * C, 2 * C, k=w), glu_bias=r(2 * C, k=0.1),
        cfc_kernel=r(2 * C, C, k=w), cfc_bias=r(C, k=0.1))


GAMMAS = {"softmax": None, "sum": 0, "attn": 1, "glu": 2, "fc": 3}


@pytest.mark.parametrize("same", [False, True], ids=["x-y", "x-is-y"])
@pytest.mark.parametrize("gammas", list(GAMMAS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_node_mixed_matches_reference(emu_libs, dtype, gammas, same):
    """B=3, L=8, C=16 (one row tile, half of it past the last row), with
    softmaxed or one-hot branch weights, and x and y one tensor or two."""
    B, L, C = 3, 8, 16
    gen = torch.Generator().manual_seed(5)
    p = _mixed_params(gen, L, C, dtype)
    x = torch.randn(B, L, C, generator=gen).to(dtype)
    y = x if same else torch.randn(B, L, C, generator=gen).to(dtype)
    if GAMMAS[gammas] is None:
        g = torch.randn(4, generator=gen).softmax(0)
    else:
        g = torch.nn.functional.one_hot(torch.tensor(GAMMAS[gammas]),
                                        4).float()
    tnm._check_mixed(x, y, g, p)
    got = tnm.launch_mixed(emu_libs["node_mixed"], x, y, g, p, 1e-5,
                           None).float()
    want = tnm.node_mixed_op_reference(x, y, g, p).float()
    tol = TOLS[dtype]
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= tol + tol * want.abs()).all(), float(
        (got - want).abs().max())


def test_node_mixed_two_row_tiles(emu_libs):
    """L=20 (a full row tile, then a ragged one) and C=32 (several K-tiles
    for both GEMMs)."""
    B, L, C = 2, 20, 32
    gen = torch.Generator().manual_seed(6)
    p = _mixed_params(gen, L, C, torch.float32)
    x, y = (torch.randn(B, L, C, generator=gen) for _ in range(2))
    g = torch.randn(4, generator=gen).softmax(0)
    got = tnm.launch_mixed(emu_libs["node_mixed"], x, y, g, p, 1e-5, None)
    want = tnm.node_mixed_op_reference(x, y, g, p)
    assert ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()


def test_node_mixed_refuses_width(emu_libs):
    """The C function refuses a width it cannot host; the binding raises."""
    B, L, C = 2, 8, 12
    gen = torch.Generator().manual_seed(7)
    p = _mixed_params(gen, L, C, torch.float32)
    x = torch.randn(B, L, C, generator=gen)
    with pytest.raises(RuntimeError, match="launch failed"):
        tnm.launch_mixed(emu_libs["node_mixed"], x, x, torch.ones(4) / 4, p,
                         1e-5, None)


# (B, L, C, samples a block, columns a block, x is y); 0: the launcher picks
MIXED_GEOMETRY_CASES = {
    "ragged-group": (5, 8, 32, 2, 0, False),   # groups of 2, the last of 1
    "ntu-width": (4, 8, 128, 2, 0, False),     # two samples, one row tile
    "c256": (2, 8, 256, 0, 32, False),         # the widest C, 8 K-tiles
    "x-is-y-ragged-cols": (3, 16, 48, 2, 32, True),  # columns 48..63 empty
    "four-samples": (6, 16, 32, 4, 16, False),  # 64 rows, 2 tiles a warp
    "three-row-tiles": (3, 24, 16, 2, 0, False),  # a unit of one row tile
    "odd-length": (5, 7, 24, 0, 0, False),     # L not a multiple of 4
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", list(MIXED_GEOMETRY_CASES))
def test_node_mixed_geometries(emu_libs, case, dtype):
    """Blocks of several samples with a ragged last group, the NTU/Ego
    width, C=256, a ragged last column tile and x is y, against
    ``node_mixed_op_reference`` at the kernel tests' tolerances."""
    B, L, C, S, nt, same = MIXED_GEOMETRY_CASES[case]
    gen = torch.Generator().manual_seed(B * 1000 + C)
    p = _mixed_params(gen, L, C, dtype)
    x = torch.randn(B, L, C, generator=gen).to(dtype)
    y = x if same else torch.randn(B, L, C, generator=gen).to(dtype)
    g = torch.randn(4, generator=gen).softmax(0)
    lib = emu_libs["node_mixed"]
    geom = tnm.mixed_geometry(lib, B, L, C, x.element_size(), S, nt)
    assert (S or geom["samples_per_block"]) == geom["samples_per_block"]
    assert (nt or geom["cols_per_block"]) == geom["cols_per_block"]
    got = tnm.launch_mixed(lib, x, y, g, p, 1e-5, None, S, nt).float()
    want = tnm.node_mixed_op_reference(x, y, g, p).float()
    tol = TOLS[dtype]
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= tol + tol * want.abs()).all(), float(
        (got - want).abs().max())


@pytest.mark.parametrize("B,S,nt,blocks", [
    (8, 1, 16, 96), (37, 2, 32, 114), (96, 2, 32, 288)])
def test_node_mixed_launcher_fills_the_card(emu_libs, B, S, nt, blocks):
    """At the MM-IMDB width (L=16, C=192) the launcher takes the least
    waves over 132 SMs (one 512-thread block an SM) times each block's
    rows x columns plus its fixed cost, in fp32 and bf16: the smallest
    blocks at the search batch, two samples and 32 columns a block above
    it."""
    for itemsize in (4, 2):
        geom = tnm.mixed_geometry(emu_libs["node_mixed"], B, 16, 192,
                                  itemsize)
        assert (geom["samples_per_block"], geom["cols_per_block"],
                geom["blocks"]) == (S, nt, blocks)
        assert geom["smem_bytes"] <= tnm.SMEM_LIMIT


def test_node_mixed_refuses_geometry(emu_libs):
    """Three samples a block is refused by the C function; more rows than
    a block's accumulators hold is refused by the binding."""
    gen = torch.Generator().manual_seed(8)
    lib = emu_libs["node_mixed"]
    p = _mixed_params(gen, 8, 16, torch.float32)
    x = torch.randn(4, 8, 16, generator=gen)
    with pytest.raises(RuntimeError, match="launch failed"):
        tnm.launch_mixed(lib, x, x, torch.ones(4) / 4, p, 1e-5, None, 3, 0)
    L = tnm.MIXED_MAX_L + 1
    p = _mixed_params(gen, L, 8, torch.float32)
    x = torch.randn(1, L, 8, generator=gen)
    with pytest.raises(ValueError, match="does not fit one block"):
        tnm.launch_mixed(lib, x, x, torch.ones(4) / 4, p, 1e-5, None)
