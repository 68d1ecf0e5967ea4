"""PyTorch port vs the JAX package: genotype core, layers and inner ops.

The same inputs, made with numpy from a seed, go through the flax module
and its port (weights carried by ``utils.convert.state_dict_from_jax``),
both in eval mode with randomized BatchNorm statistics. fp32 on the CPU;
tolerance 2e-5 (the two frameworks sum in different orders).
"""
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmnas_tpu import genotype as JG
from bmnas_tpu.ops import fusion_ops as jops
from bmnas_tpu.ops import layers as jlayers
from bmnas_tpu_torch import genotype as TG
from bmnas_tpu_torch.ops import fusion_ops as tops
from bmnas_tpu_torch.ops import layers as tlayers
from bmnas_tpu_torch.utils.convert import state_dict_from_jax

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "reference_best_genotype.pkl")
TOL = dict(rtol=2e-5, atol=2e-5)


def _randomized(variables, seed):
    """Every leaf shifted by U(0, 0.5): BN stats and affines are exercised,
    variances stay positive."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.rand(*np.shape(a)).astype(np.float32)
        * 0.5, jax.tree_util.tree_map(np.asarray, dict(variables)))


def _port(module, variables):
    module.load_state_dict(state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {})))
    return module.eval()


def _compare(jmod, tmod, *inputs, seed=0, train_arg=True):
    """Init the flax module, randomize, carry weights, compare eval outputs.
    ``train_arg``: the flax module takes a trailing ``train`` flag."""
    jin = [jnp.asarray(a) for a in inputs] + ([False] if train_arg else [])
    variables = jmod.init(jax.random.PRNGKey(seed), *jin)
    variables = _randomized(variables, seed)
    want = np.asarray(jmod.apply(variables, *jin))
    if "params" in variables:
        _port(tmod, variables)
    tmod.eval()
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(a) for a in inputs]).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# genotype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_genotype_derivation_matches(seed, tmp_path):
    rng = np.random.RandomState(seed)
    steps, n_in, node_steps = 2 + seed % 2, 6, 1 + seed % 3
    n_alpha = sum(n_in + i for i in range(steps))
    alphas = rng.randn(n_alpha, 2)
    betas = [rng.randn(sum(2 + i for i in range(node_steps)), 2)
             for _ in range(steps)]
    gammas = [rng.randn(node_steps, 4) for _ in range(steps)]
    args = (alphas, betas, gammas, steps, 2, n_in, node_steps, 1)
    want, got = JG.derive_genotype(*args), TG.derive_genotype(*args)
    assert got == want
    JG.save_genotype(want, str(tmp_path / "jax.pkl"))
    TG.save_genotype(got, str(tmp_path / "port.pkl"))
    assert filecmp.cmp(tmp_path / "jax.pkl", tmp_path / "port.pkl",
                       shallow=False)
    assert TG.load_genotype(str(tmp_path / "jax.pkl")) == want
    assert JG.load_genotype(str(tmp_path / "port.pkl")) == want


def test_genotype_loads_reference_fixture():
    got = TG.load_genotype(FIXTURE)
    assert got == JG.load_genotype(FIXTURE)
    assert isinstance(got, TG.Genotype)
    assert isinstance(got.steps[0], TG.StepGenotype)
    with open(FIXTURE, "rb") as f:
        assert TG.loads_genotype(f.read()) == got


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

RNG = np.random.RandomState(0)


def _x(*shape):
    return RNG.randn(*shape).astype(np.float32)


def test_layernorm2d():
    _compare(jlayers.LayerNorm2D(), tlayers.LayerNorm2D(4, 6), _x(3, 4, 6),
             train_arg=False)


@pytest.mark.parametrize("shape", [(5, 7), (2, 3, 4, 7)])
def test_batchnorm_eval(shape):
    _compare(jlayers.BatchNorm(), tlayers.BatchNorm(7), _x(*shape))


def test_global_pooling_2d():
    x = _x(2, 5, 3, 4)
    want = np.asarray(jlayers.GlobalPooling2D().apply({}, jnp.asarray(x)))
    got = tlayers.GlobalPooling2D()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_maxout_order():
    _compare(jlayers.Maxout(features=6, pool_size=5),
             tlayers.Maxout(10, 6, 5), _x(3, 10), train_arg=False)


@pytest.mark.parametrize("in_size,out_size", [(13, 4), (3, 7), (8, 8)])
def test_adaptive_pools(in_size, out_size):
    x = _x(2, in_size, in_size + 2, 3)
    want = np.asarray(jlayers.adaptive_max_pool_2d(
        jnp.asarray(x), (out_size, out_size + 1)))
    got = tlayers.adaptive_max_pool_2d(torch.from_numpy(x),
                                       (out_size, out_size + 1)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    want1 = np.asarray(jlayers.adaptive_max_pool_1d(jnp.asarray(x),
                                                    out_size, axis=1))
    got1 = tlayers.adaptive_max_pool_1d(torch.from_numpy(x), out_size,
                                        axis=1).numpy()
    np.testing.assert_allclose(got1, want1, **TOL)
    want2 = np.asarray(jlayers.interpolate_nearest_1d(jnp.asarray(x),
                                                      out_size, axis=1))
    got2 = tlayers.interpolate_nearest_1d(torch.from_numpy(x), out_size,
                                          axis=1).numpy()
    np.testing.assert_allclose(got2, want2, **TOL)


@pytest.mark.parametrize("shape", [(3, 10), (3, 7, 5, 10)])
def test_reshape_input_layer_mmimdb(shape):
    _compare(jlayers.ReshapeInputLayerMMIMDB(C=6, L=4, drpt=0.0),
             tlayers.ReshapeInputLayerMMIMDB(10, 6, 4, 0.0), _x(*shape))


def _grad_fns(t):
    """Names of every autograd node behind ``t``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and fn not in seen:
            seen.add(fn)
            todo += [nxt for nxt, _ in fn.next_functions]
    return {type(fn).__name__ for fn in seen}


def test_reshape_input_layer_mmimdb_vectors_skip_the_pool():
    """(B, C_in) vectors are replicated into the L bins without the
    adaptive max pool, whose CUDA backward adds the L gradients of a 1x1
    map by atomics in no fixed order (found retraining trains the text
    backbone through this layer, so ``--resume`` could not match an
    uninterrupted run): the same output and input gradient as the pool,
    and no pool in the backward graph."""
    torch.manual_seed(0)
    layer = tlayers.ReshapeInputLayerMMIMDB(10, 6, 16, 0.0).train()
    x = torch.from_numpy(_x(3, 10)).requires_grad_()
    out = layer(x)
    assert not any("AdaptiveMaxPool" in n for n in _grad_fns(out))
    (gx,) = torch.autograd.grad(out.square().sum(), x)
    xp = x.detach().clone().requires_grad_()
    pooled = tlayers.adaptive_max_pool_2d(xp[:, None, None, :], (4, 4))
    want = layer.project(pooled.reshape(3, 16, 10))
    (gxp,) = torch.autograd.grad(want.square().sum(), xp)
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gx, gxp, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dims,H,W", [(1, 7, 6), (2, 7, 6), (1, 8, 6),
                                       (2, 8, 12)],
                         ids=["1d", "2d", "1d-even", "2d-even"])
def test_adaptive_pool_tie_gradient_matches_jax(dims, H, W):
    """Inputs from {0, 1, 2}, so most bins hold ties, and bins that overlap
    (7 -> 4, 6 -> 4) or split the axis evenly (8 -> 4, 12 -> 4): the input
    gradient of a weighted sum of the pool against ``jax.grad`` of the JAX
    pool, which splits a tie's gradient evenly (``F.adaptive_max_pool*``
    sent it all to one element)."""
    rng = np.random.RandomState(7)
    x = rng.randint(0, 3, (2, H, W, 3)).astype(np.float32)
    if dims == 1:
        jpool = lambda a: jlayers.adaptive_max_pool_1d(a, 4, axis=1)  # noqa: E731
        tpool = lambda a: tlayers.adaptive_max_pool_1d(a, 4, axis=1)  # noqa: E731
    else:
        jpool = lambda a: jlayers.adaptive_max_pool_2d(a, (4, 4))  # noqa: E731
        tpool = lambda a: tlayers.adaptive_max_pool_2d(a, (4, 4))  # noqa: E731
    w = rng.randn(*np.shape(jpool(jnp.asarray(x)))).astype(np.float32)
    want = np.asarray(jax.grad(lambda a: (jpool(a) * w).sum())(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad((tpool(xt) * torch.from_numpy(w)).sum(), xt)
    assert (want != np.round(want)).any()  # some gradient was split
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layer,shape", [
    ("ntu", (3, 9, 10)), ("ntu", (3, 9, 4, 5, 10)), ("mmimdb", (3, 7, 5, 10)),
    ("mmimdb", (3, 10))])
def test_reshape_layers_have_no_adaptive_pool_backward(layer, shape):
    """Neither reshape layer leaves an ``AdaptiveMaxPool*Backward`` node in
    the graph: the CUDA backward of those pools adds by atomics in no fixed
    order, which ``--resume`` on the card cannot reproduce."""
    cls = (tlayers.ReshapeInputLayer if layer == "ntu"
           else tlayers.ReshapeInputLayerMMIMDB)
    x = torch.from_numpy(_x(*shape)).requires_grad_()
    names = _grad_fns(cls(10, 6, 4, 0.0).train()(x))
    assert names and not any("AdaptiveMaxPool" in n for n in names), names


def test_reshape_input_layer_mmimdb_needs_square_L():
    with pytest.raises(ValueError, match="perfect square"):
        tlayers.ReshapeInputLayerMMIMDB(10, 6, 8, 0.0)


@pytest.mark.parametrize("shape", [(3, 10), (3, 9, 10), (3, 9, 4, 5, 10)])
def test_reshape_input_layer(shape):
    _compare(jlayers.ReshapeInputLayer(C=6, L=4, drpt=0.0),
             tlayers.ReshapeInputLayer(10, 6, 4, 0.0), _x(*shape))


# ---------------------------------------------------------------------------
# edge and inner fusion ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["none", "skip", "fc_relu", "fc_mish"])
def test_edge_op(kind):
    x = _x(3, 4, 6)
    jmod = jops.EdgeOp(kind=kind, C=6, drpt=0.0)
    tmod = tops.EdgeOp(kind, 6, 0.0)
    _compare(jmod, tmod, x)
    assert tmod.has_params == (kind in ("fc_relu", "fc_mish"))


@pytest.mark.parametrize("op", ["Sum", "ScaleDotAttn", "LinearGLU",
                                "ConcatFC", "cat_conv_relu"])
def test_step_ops(op):
    x, y = _x(3, 4, 6), _x(3, 4, 6)
    jmod = jops.STEP_OPS[op](6, 4, 0.0)
    tmod = tops.STEP_OPS[op](6, 4, 0.0)
    _compare(jmod, tmod, x, y)
