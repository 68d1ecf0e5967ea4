"""The port's supernet mixed op, its kernel's plain version and BatchNorm
against the JAX package.

Inputs and weights are made with numpy from a seed; weights are carried
into the port with ``state_dict_from_jax``. fp32 on the CPU. The JAX mixed
op runs its Pallas kernel in interpret mode. Dropout is off on both sides:
flax's by an ``intercept_methods`` hook, the port's by eval-mode Dropout
modules inside a train-mode op.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmnas_tpu.ops import fusion_ops as jops
from bmnas_tpu.ops import layers as jlayers
from bmnas_tpu.ops.kernels import node_mixed as jnm
from bmnas_tpu_torch.ops import fusion_ops as tops
from bmnas_tpu_torch.ops import layers as tlayers
from bmnas_tpu_torch.ops.kernels import LAUNCHES
from bmnas_tpu_torch.ops.kernels import node_mixed as tnm
from bmnas_tpu_torch.utils.convert import state_dict_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)


def _no_dropout(next_fn, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fn(*args, **kwargs)


def _dropout_off(module):
    """Train mode with every Dropout module in eval mode."""
    module.train()
    for m in module.modules():
        if isinstance(m, torch.nn.Dropout):
            m.eval()
    return module


def _gammas(kind, rng):
    if kind == "softmax":
        return jax.nn.softmax(jnp.asarray(rng.randn(4).astype(np.float32)))
    return jnp.asarray(np.eye(4, dtype=np.float32)[
        ["sum", "attn", "glu", "fc"].index(kind)])


def _params(rng, L, C):
    a = {"ln_scale": rng.randn(L, C), "ln_bias": rng.randn(L, C),
         "glu_kernel": rng.randn(2 * C, 2 * C) * 0.1,
         "glu_bias": rng.randn(2 * C), "cfc_kernel": rng.randn(2 * C, C) * 0.1,
         "cfc_bias": rng.randn(C)}
    a = {k: v.astype(np.float32) for k, v in a.items()}
    return (jnm.NodeMixedParams(**{k: jnp.asarray(v) for k, v in a.items()}),
            tnm.NodeMixedParams(**{k: torch.from_numpy(v)
                                   for k, v in a.items()}))


@pytest.mark.parametrize("gammas", ["softmax", "sum", "attn", "glu", "fc"])
@pytest.mark.parametrize("B,L,C", [(2, 8, 16), (3, 16, 192)])
def test_reference_matches_jax_kernel(B, L, C, gammas):
    """node_mixed_op_reference (and the wrapper on CPU tensors) against
    the JAX Pallas kernel in interpret mode, at 2e-4."""
    rng = np.random.RandomState(B * 100 + C)
    x = rng.randn(B, L, C).astype(np.float32)
    y = rng.randn(B, L, C).astype(np.float32)
    g = _gammas(gammas, rng)
    jp, tp = _params(rng, L, C)
    want = np.asarray(jnm.node_mixed_op_fused(
        jnp.asarray(x), jnp.asarray(y), g, jp, interpret=True))
    tx, ty, tg = (torch.from_numpy(np.array(a)) for a in (x, y, g))
    got = tnm.node_mixed_op_reference(tx, ty, tg, tp)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    before = LAUNCHES["node_mixed"]
    fused = tnm.node_mixed_op_fused(tx, ty, tg, tp)
    assert LAUNCHES["node_mixed"] == before  # the CPU takes the plain path
    np.testing.assert_array_equal(fused.numpy(), got.numpy())


def test_reference_same_tensor_as_both_inputs():
    """The supernet passes one tensor as x and y."""
    rng = np.random.RandomState(7)
    x = rng.randn(3, 16, 192).astype(np.float32)
    g = _gammas("softmax", rng)
    jp, tp = _params(rng, 16, 192)
    want = np.asarray(jnm.node_mixed_op_fused(
        jnp.asarray(x), jnp.asarray(x), g, jp, interpret=True))
    tx = torch.from_numpy(x)
    got = tnm.node_mixed_op_reference(tx, tx, torch.from_numpy(np.array(g)),
                                      tp)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def _randomized(variables, seed):
    """BatchNorm statistics, affines and biases shifted by U(0, 0.5)."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.rand(*np.shape(a)).astype(np.float32)
        * 0.5, jax.tree_util.tree_map(np.asarray, dict(variables)))


C, L = 8, 4


@pytest.fixture
def ops():
    """(flax op, its randomized variables, the port's op with them)."""
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(3, L, C).astype(np.float32))
    jop = jops.NodeMixedOp(C=C, L=L, drpt=0.1)
    variables = _randomized(jop.init(jax.random.PRNGKey(0), x, x,
                                     jnp.ones(4) / 4, False), 0)
    top = tops.NodeMixedOp(C, L, 0.1)
    top.load_state_dict(state_dict_from_jax(variables["params"],
                                            variables["batch_stats"]))
    return jop, variables, top


def test_params_from_module_matches_params_from_flax(ops):
    _, variables, top = ops
    want = jnm.params_from_flax(variables)
    got = tnm.params_from_module(top)
    for name in ("ln_scale", "ln_bias", "glu_kernel", "glu_bias",
                 "cfc_kernel", "cfc_bias"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
        assert getattr(got, name).is_contiguous()
    # a copy: never an alias of a parameter
    assert got.ln_scale.data_ptr() != \
        top.ScaledDotAttn_0.LayerNorm2D_0.weight.data_ptr()


def _batch(seed, n=5):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, L, C).astype(np.float32),
            jax.nn.softmax(jnp.asarray(rng.randn(4).astype(np.float32))))


def test_node_mixed_op_eval_matches_jax(ops):
    jop, variables, top = ops
    x, g = _batch(1)
    want = np.asarray(jop.apply(variables, jnp.asarray(x), jnp.asarray(x),
                                g, False))
    tx, tg = torch.from_numpy(x), torch.from_numpy(np.array(g))
    with torch.no_grad():
        got = top.eval()(tx, tx, tg)  # CPU eval: the composite
        folded = tnm.node_mixed_op_fused(tx, tx, tg,
                                         tnm.params_from_module(top))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(folded.numpy(), want, **TOL)


def test_node_mixed_op_train_matches_jax(ops):
    """Train mode: batch statistics in both BatchNorms, and the running
    statistics they leave behind."""
    jop, variables, top = ops
    x, g = _batch(2)
    with nn.intercept_methods(_no_dropout):
        want, mut = jop.apply(variables, jnp.asarray(x), jnp.asarray(x), g,
                              True, rngs={"dropout": jax.random.PRNGKey(1)},
                              mutable=["batch_stats"])
    tx = torch.from_numpy(x)
    with torch.no_grad():
        got = _dropout_off(top)(tx, tx, torch.from_numpy(np.array(g)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_sd = state_dict_from_jax(variables["params"], mut["batch_stats"])
    for k, v in top.state_dict().items():
        if "running" in k:
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_fold_follows_a_train_step(ops):
    """Eval -> one train step (SGD on the parameters, BatchNorm update) ->
    eval: the folded parameters follow the step, as the JAX package's
    ``params_from_flax`` of the stepped variables does."""
    jop, variables, top = ops
    xe, g = _batch(3)
    xt, _ = _batch(4, n=6)
    proj = np.random.RandomState(5).randn(6, L, C).astype(np.float32)
    lr = 0.1

    def j_eval(vs):
        return np.asarray(jop.apply(vs, jnp.asarray(xe), jnp.asarray(xe), g,
                                    False))

    def j_loss(params):
        with nn.intercept_methods(_no_dropout):
            out, mut = jop.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jnp.asarray(xt), jnp.asarray(xt), g, True,
                rngs={"dropout": jax.random.PRNGKey(2)},
                mutable=["batch_stats"])
        return jnp.sum(out * proj), mut["batch_stats"]

    grads, stats = jax.grad(j_loss, has_aux=True)(variables["params"])
    stepped = {"params": jax.tree_util.tree_map(
        lambda p, d: p - lr * d, variables["params"], grads),
        "batch_stats": stats}

    tg = torch.from_numpy(np.array(g))
    txe = torch.from_numpy(xe)
    with torch.no_grad():
        top.eval()
        p0 = tnm.params_from_module(top)
        np.testing.assert_allclose(
            tnm.node_mixed_op_fused(txe, txe, tg, p0).numpy(),
            j_eval(variables), **TOL)
    opt = torch.optim.SGD(top.parameters(), lr=lr)
    txt = torch.from_numpy(xt)
    (_dropout_off(top)(txt, txt, tg) * torch.from_numpy(proj)).sum() \
        .backward()
    opt.step()
    with torch.no_grad():
        top.eval()
        p1 = tnm.params_from_module(top)
        got = tnm.node_mixed_op_fused(txe, txe, tg, p1)
        want = j_eval(stepped)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(top(txe, txe, tg).numpy(), want,
                                   rtol=1e-4, atol=1e-4)
    want_p = jnm.params_from_flax(stepped)
    for name in ("glu_kernel", "glu_bias", "cfc_kernel", "cfc_bias"):
        np.testing.assert_allclose(getattr(p1, name).numpy(),
                                   np.asarray(getattr(want_p, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("padded", [0, 3], ids=["full", "padded"])
@pytest.mark.parametrize("shape", [(8, 6), (8, 4, 6)])
def test_batchnorm_train_matches_flax(shape, padded):
    """One train-mode forward: flax's BatchNorm and the port's give the same
    output and the same running mean and (biased) running variance, with
    the zero rows of a padded final batch counted, to 1e-6."""
    rng = np.random.RandomState(sum(shape) + padded)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    if padded:
        x[-padded:] = 0.0
    jbn = jlayers.BatchNorm()
    variables = _randomized(jbn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                     False), 1)
    want, mut = jbn.apply(variables, jnp.asarray(x), True,
                          mutable=["batch_stats"])
    tbn = tlayers.BatchNorm(shape[-1])
    tbn.load_state_dict(state_dict_from_jax(variables["params"],
                                            variables["batch_stats"]))
    got = tbn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    stats = mut["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6,
                               atol=1e-6)
    assert int(tbn.num_batches_tracked) == 1
