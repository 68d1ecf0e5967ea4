"""The blockwise attention kernel (``csrc/attention.cu`` with
``tc_gemm.cuh``) run on the CPU by emulation (``tests/_kernel_emu.py``),
through the port's bindings, against ``reference_attention``: the shapes,
the geometries, the launcher's picks and the C function's refusals; and
the stand-in WMMA's col_major operand by itself. Skips where there is no
``g++``.
"""
import ctypes
import math

import pytest
import torch

from _kernel_emu import emu_libs  # noqa: F401 (fixture)
from bmnas_tpu_torch.ops.kernels import attention as tat
from bmnas_tpu_torch.ops.kernels import node_mixed as tnm

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,Lq,Lk,scale", [
    (2, 5, 3, 1.0),      # Lk and Lq below one tile, Lq != Lk
    (1, 70, 130, 1.0),   # two query tiles, three key tiles, both ragged
    (1, 9, 67, 30.0),    # large scores across a ragged key tile
], ids=["short", "ragged-tiles", "x30"])
def test_attention_matches_reference(emu_libs, B, Lq, Lk, scale, dtype):
    """C=24 (six channel quads, not a power of two) through the port's
    binding against ``reference_attention`` on the same inputs; fp32
    output whatever the input type."""
    gen = torch.Generator().manual_seed(Lq * 1000 + Lk)
    x = (torch.randn(B, Lq, 24, generator=gen) * scale).to(dtype)
    y = (torch.randn(B, Lk, 24, generator=gen) * scale).to(dtype)
    tat._check(x, y, 128, 128)
    got = tat.launch(emu_libs["attention"], x, y, None)
    want = tat.reference_attention(x, y)
    assert got.dtype == torch.float32 and got.shape == (B, Lq, 24)
    assert torch.isfinite(got).all()
    # the JAX kernel test's tolerances: 2e-4 / 2e-5, 1e-3 for the x30 case
    rtol, atol = (2e-4, 2e-5) if scale == 1.0 else (1e-3, 1e-3)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


def test_attention_refuses_width(emu_libs):
    """The C function refuses C=12; the binding raises."""
    x = torch.randn(1, 4, 12)
    with pytest.raises(RuntimeError, match="launch failed"):
        tat.launch(emu_libs["attention"], x, x, None)


def _attention_case(lib, B, Lq, Lk, C, dtype, seed, scale=1.0, **geom):
    """The kernel (the launcher's geometry, or the one ``geom`` fixes)
    against ``reference_attention`` on the same inputs, at the JAX kernel
    test's tolerances: both sides read the same bf16 values and sum in
    fp32, so bf16 is held to them too."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, Lq, C, generator=gen) * scale).to(dtype)
    y = (torch.randn(B, Lk, C, generator=gen) * scale).to(dtype)
    tat._check(x, y, 128, 128)
    got = tat.launch(lib, x, y, None, **geom)
    want = tat.reference_attention(x, y)
    assert got.dtype == torch.float32 and got.shape == (B, Lq, C)
    assert torch.isfinite(got).all()
    rtol, atol = (2e-4, 2e-5) if scale == 1.0 else (1e-3, 1e-3)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("C", [192, 256])
def test_attention_wide_channels(emu_libs, C, dtype):
    """The MM-IMDB width and the widest C at ragged lengths (Lq=33: three
    query groups, the last of one row; Lk=70: a full key tile and a ragged
    one); C=256 needs two warps a group for its 16 output tiles."""
    _attention_case(emu_libs["attention"], 1, 33, 70, C, dtype, seed=C)


def test_attention_bf16_ragged_key_tile(emu_libs):
    """C=24 bf16 (padded to 32 channels in shared memory) with 32-key tiles,
    the last of 13 keys: its zero rows and masked scores."""
    _attention_case(emu_libs["attention"], 2, 20, 45, 24, torch.bfloat16,
                    seed=45, bk=32)


# (wq, wc, bk): every way a block splits its work
ATTN_GEOMETRIES = [(1, 1, 32), (1, 4, 64), (2, 2, 32), (4, 2, 64)]


def _max_moves(x, y, bk, slack=8.0):
    """Whether some row's score max (log2 units) rises past the kernel's
    running max by more than its slack after the first key tile, so that
    the accumulator is rescaled."""
    s = torch.einsum("blc,bmc->blm", x.double(), y.double()) \
        / math.sqrt(x.shape[-1]) * math.log2(math.e)
    m = s[..., :bk].amax(-1)
    for k0 in range(bk, s.shape[-1], bk):
        t = s[..., k0:k0 + bk].amax(-1)
        if bool((t > m + slack).any()):
            return True
        m = torch.where(t > m + slack, t, m)
    return False


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("wq,wc,bk", ATTN_GEOMETRIES,
                         ids=[f"wq{a}-wc{b}-bk{c}" for a, b, c in
                              ATTN_GEOMETRIES])
def test_attention_geometries(emu_libs, wq, wc, bk, dtype):
    """C=40 (three output tiles, so warps own different counts of them),
    Lq=37, Lk=100 under each geometry. Key j is scaled by 1 + 0.05 j, so
    the running max moves in later key tiles and O is rescaled, while the
    softmax stays well conditioned: the fp32 reference is within the
    tolerances of a float64 one, and the kernel is held to them."""
    lib = emu_libs["attention"]
    itemsize = 4 if dtype == torch.float32 else 2
    geom = tat.geometry(lib, 2, 37, 100, 40, itemsize, wq, wc, bk)
    assert (geom["wq"], geom["wc"], geom["bk"]) == (wq, wc, bk)
    assert geom["threads"] == 32 * wq * wc
    assert geom["blocks"] == 2 * -(-37 // (16 * wq))
    gen = torch.Generator().manual_seed(wq * 100 + wc * 10 + bk)
    x = torch.randn(2, 37, 40, generator=gen).to(dtype)
    ramp = 1 + 0.05 * torch.arange(100).view(1, 100, 1)
    y = (torch.randn(2, 100, 40, generator=gen) * ramp).to(dtype)
    assert _max_moves(x, y, bk)
    got = tat.launch(lib, x, y, None, wq=wq, wc=wc, bk=bk)
    want = tat.reference_attention(x, y)
    xd, yd = x.double(), y.double()
    exact = (torch.einsum("blc,bmc->blm", xd, yd) / math.sqrt(40)).softmax(
        -1) @ yd
    torch.testing.assert_close(want.double(), exact, rtol=2e-4, atol=2e-5)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("B,L,pick", [
    (8, 512, (2, 4, 64, 128)),
    (8, 4096, (4, 2, 64, 512)),
    (1, 16, (1, 4, 64, 1)),
], ids=["B8-L512", "B8-L4096", "B1-L16"])
def test_attention_launcher_picks(emu_libs, B, L, pick):
    """At C=192 the launcher spreads the work over the card's 132 SMs: at
    L=512 two query groups of four warps a block (128 blocks, one wave), at
    L=4096 four groups of two warps (512 blocks), at B=1, L=16 one group of
    four warps; in fp32 and bf16, within the shared memory a block may
    take."""
    for itemsize in (4, 2):
        g = tat.geometry(emu_libs["attention"], B, L, L, 192, itemsize)
        assert (g["wq"], g["wc"], g["bk"], g["blocks"]) == pick, g
        assert g["blocks_per_sm"] >= 1
        assert g["smem_bytes"] <= tnm.SMEM_LIMIT
    assert emu_libs["attention"].attention_smem_bytes(256, 4) \
        <= tnm.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_stand_in_col_major_load(emu_libs, dtype):
    """The stand-in's col_major B operand read from a row-major k gives
    a k^T: one warp's MMA against the transposed product, on values exact
    in TF32 and bf16."""
    kk = 8 if dtype == torch.float32 else 16
    gen = torch.Generator().manual_seed(kk)
    a = (torch.randint(-8, 9, (16, kk), generator=gen) / 4).to(dtype)
    k = (torch.randint(-8, 9, (16, kk), generator=gen) / 4).to(dtype)
    d = torch.full((16, 16), float("nan"))
    rc = emu_libs["selftest"].emu_col_major_product(
        ctypes.c_int(int(dtype == torch.bfloat16)),
        ctypes.c_void_p(a.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(d.data_ptr()))
    assert rc == 0
    torch.testing.assert_close(d, a.float() @ k.float().T, rtol=0, atol=0)
