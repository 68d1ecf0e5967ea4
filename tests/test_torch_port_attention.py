"""The port's blockwise scaled-dot attention against the JAX package.

The JAX kernel runs in interpret mode, as its own test runs it on the CPU
(``tests/test_attention_kernel.py``), on the same numpy inputs as the port's
plain version ``reference_attention`` and the CPU path of the port's wrapper
``blockwise_scaled_dot_attention``. The five cases, blocks and tolerances
are the JAX test's. The CUDA kernel itself is checked by the CPU emulation
test and by ``chip_smoke.py`` on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmnas_tpu.ops.kernels import attention as ja
from bmnas_tpu_torch.ops.kernels import LAUNCHES
from bmnas_tpu_torch.ops.kernels import attention as ta

CASES = [  # B, Lq, Lk, C, block_q, block_k, scale, rtol, atol
    (2, 16, 16, 192, 128, 128, 1.0, 2e-4, 2e-5),   # one block
    (2, 256, 256, 64, 128, 128, 1.0, 2e-4, 2e-5),  # blocks on both axes
    (1, 100, 100, 64, 32, 32, 1.0, 2e-4, 2e-5),    # padding on both axes
    (2, 64, 192, 32, 32, 64, 1.0, 2e-4, 2e-5),     # Lq != Lk
    (1, 64, 64, 32, 32, 32, 30.0, 1e-3, 1e-3),     # online-softmax stability
]
IDS = ["single-block", "multi-block", "padded", "asymmetric", "x30"]


def _inputs(B, Lq, Lk, C, scale, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, Lq, C).astype(np.float32) * np.float32(scale)
    y = rng.randn(B, Lk, C).astype(np.float32) * np.float32(scale)
    return x, y


@pytest.mark.parametrize("B,Lq,Lk,C,bq,bk,scale,rtol,atol", CASES, ids=IDS)
def test_matches_jax_kernel(B, Lq, Lk, C, bq, bk, scale, rtol, atol):
    x, y = _inputs(B, Lq, Lk, C, scale, seed=Lq + Lk + C)
    want = np.asarray(ja.blockwise_scaled_dot_attention(
        jnp.asarray(x), jnp.asarray(y), block_q=bq, block_k=bk,
        interpret=True))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    before = LAUNCHES["attention"]
    for got in (ta.reference_attention(tx, ty),
                ta.blockwise_scaled_dot_attention(tx, ty, block_q=bq,
                                                  block_k=bk)):
        assert got.dtype == torch.float32 and got.shape == (B, Lq, C)
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    assert LAUNCHES["attention"] == before  # the CPU never launches it


@pytest.mark.parametrize("case", [0, 3], ids=["single-block", "asymmetric"])
def test_bf16_inputs_give_fp32(case):
    """bf16 x and y are read as they are and accumulated in fp32; the
    output is fp32, within 2e-2 of JAX's kernel on the fp32 inputs."""
    B, Lq, Lk, C, bq, bk, scale, _, _ = CASES[case]
    x, y = _inputs(B, Lq, Lk, C, scale, seed=7)
    want = np.asarray(ja.blockwise_scaled_dot_attention(
        jnp.asarray(x), jnp.asarray(y), block_q=bq, block_k=bk,
        interpret=True))
    got = ta.blockwise_scaled_dot_attention(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(y).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_wrapper_refuses_what_the_kernel_cannot_take():
    x = torch.randn(2, 8, 16)
    f = ta.blockwise_scaled_dot_attention
    with pytest.raises(ValueError, match="y on meta"):
        f(x, torch.empty(2, 8, 16, device="meta"))  # mixed devices
    with pytest.raises(ValueError, match="contiguous"):
        f(x, torch.randn(2, 16, 8).transpose(1, 2))
    with pytest.raises(TypeError, match="dtypes"):
        f(x, x.double())
    with pytest.raises(ValueError, match="C=12"):
        f(torch.randn(1, 4, 12), torch.randn(1, 4, 12))
    with pytest.raises(ValueError, match="block_k"):
        f(x, x, block_k=0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        f(x.to("meta"), x.to("meta"))
