"""The port's NTU models against the JAX package: HCN, the inflated 3D
ResNet-50, the found task net, and the 5-D kernel mapping.

Each flax module is initialised, its BatchNorm statistics, affines and
biases randomized, and its weights carried into the port with
``state_dict_from_jax``; the same inputs, made with numpy from a seed, go
through both in eval mode. fp32 on the CPU. Tolerances: 1e-5 for HCN and
the ResNet taps (the two frameworks sum the convolutions in different
orders), 1e-4 for the found net's logits, as for MM-IMDB's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmnas_tpu.genotype import Genotype, StepGenotype
from bmnas_tpu.models.hcn import HCN as JHCN
from bmnas_tpu.models.inflated_resnet import InflatedResNet50 as JResNet
from bmnas_tpu.models.ntu import FoundSkeletonImageNet as JNet
from bmnas_tpu.models.ntu import normalize_uint8_clip as jnormalize
from bmnas_tpu_torch.models.hcn import HCN, motion_of
from bmnas_tpu_torch.models.inflated_resnet import InflatedResNet50
from bmnas_tpu_torch.models.ntu import FoundSkeletonImageNet
from bmnas_tpu_torch.models.ntu import normalize_uint8_clip
from bmnas_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from bmnas_tpu_torch.utils.convert import state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)
# two found cells of two chained inner steps (step 1 reads step 0's output)
# and a node multiplier of 2: every inner op, the out-conv, and an outer
# edge that reads the first cell's output (index 8)
GENO = Genotype(
    edges=[("skip", 1), ("skip", 5), ("skip", 3), ("skip", 8)],
    concat=[8, 9],
    steps=[StepGenotype([("skip", 0), ("skip", 1), ("skip", 2), ("skip", 0)],
                        ["LinearGLU", "ConcatFC"], [2, 3]),
           StepGenotype([("skip", 1), ("skip", 0), ("skip", 0), ("skip", 2)],
                        ["ScaleDotAttn", "Sum"], [2, 3])],
)
CFG = dict(C=8, L=4, steps=2, multiplier=2, node_steps=2, node_multiplier=2,
           num_input_nodes=8, num_keep_edges=2, num_outputs=6, drpt=0.0)


def _randomized(variables, seed=0):
    """BatchNorm statistics, affines and biases shifted by U(0, 0.1);
    kernels keep their init scale."""
    rng = np.random.RandomState(seed)

    def shift(path, a):
        a = np.asarray(a)
        if path[-1].key == "kernel":
            return a
        return a + rng.rand(*a.shape).astype(np.float32) * 0.1
    return jax.tree_util.tree_map_with_path(
        shift, jax.tree_util.tree_map(np.asarray, dict(variables)))


def _port(module, variables):
    module.load_state_dict(state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {})))
    return module.eval()


def _skeleton(n, seed=0):
    return np.random.RandomState(seed).randn(n, 32, 25, 2, 3).astype(
        np.float32)


def _batch(n, valid=None, seed=1, frames=2, hw=32):
    rng = np.random.RandomState(seed)
    b = {"image": rng.randint(0, 256, (n, frames, hw, hw, 3)).astype(
             np.uint8),
         "skeleton": rng.randn(n, 32, 25, 2, 3).astype(np.float32) * 0.1,
         "mask": np.zeros((n,), np.float32)}
    b["mask"][:n if valid is None else valid] = 1.0
    return b


def test_motion_edge_frames_match_jax_resize():
    """The frame differences resized T-1 -> T: jax.image.resize('linear')
    against F.interpolate(align_corners=False), the edge frames included
    (each takes its nearest difference, unblended)."""
    x = _skeleton(2)
    d = x[:, 1:] - x[:, :-1]
    want = np.asarray(jax.image.resize(jnp.asarray(d), x.shape, "linear"))
    got = motion_of(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got[:, 0], d[:, 0], **TOL)
    np.testing.assert_allclose(got[:, -1], d[:, -1], **TOL)


def test_hcn_hidden_and_logits_match():
    x = _skeleton(3, seed=2)
    jmod = JHCN(num_outputs=6, drpt=0.0)
    variables = _randomized(jax.jit(lambda k, x: jmod.init(k, x, False))(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    want_hidden, want_logits = jmod.apply(variables, jnp.asarray(x), False)
    tmod = _port(HCN(6, 0.0), variables)
    with torch.no_grad():
        got_hidden, got_logits = tmod(torch.from_numpy(x))
    assert len(got_hidden) == len(want_hidden) == 8
    for i, (g, w) in enumerate(zip(got_hidden, want_hidden)):
        assert tuple(g.shape) == w.shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=str(i),
                                   **TOL)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **TOL)


def test_inflated_resnet_taps_match():
    """Small widths (1, 1, 2, 1 blocks), a 2-frame 32x32 clip: the stem's
    -inf-padded max pool, the spatial-only strides and the downsampling
    projections."""
    clip = np.random.RandomState(3).randn(2, 2, 32, 32, 3).astype(np.float32)
    kw = dict(layers=(1, 1, 2, 1), channels=(8, 16, 32, 64))
    jmod = JResNet(**kw)
    variables = _randomized(jax.jit(lambda k, x: jmod.init(k, x, False))(
        jax.random.PRNGKey(1), jnp.asarray(clip)), seed=1)
    want = jmod.apply(variables, jnp.asarray(clip), False)
    tmod = _port(InflatedResNet50(**kw), variables)
    with torch.no_grad():
        got = tmod(torch.from_numpy(clip))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (2, 2, 8, 8, 32), (2, 2, 4, 4, 64), (2, 2, 2, 2, 128),
        (2, 2, 1, 1, 256)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_normalize_uint8_clip_matches():
    b = _batch(3, valid=2)
    want = np.asarray(jnormalize(jnp.asarray(b["image"]),
                                 jnp.asarray(b["mask"])))
    got = normalize_uint8_clip(torch.from_numpy(b["image"]),
                               torch.from_numpy(b["mask"])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert not got[2].any()  # the padded row stays zero
    f = torch.from_numpy(got)
    assert normalize_uint8_clip(f) is f


def test_five_d_kernel_mapping():
    """A flax (kT, kH, kW, I, O) kernel becomes Conv3d's (O, I, kT, kH, kW):
    a non-cubic kernel on a non-cubic input, against flax's own conv."""
    import flax.linen as fnn
    x = np.random.RandomState(4).randn(2, 5, 6, 7, 3).astype(np.float32)
    conv = fnn.Conv(4, (3, 1, 2), padding="VALID", use_bias=False)
    variables = conv.init(jax.random.PRNGKey(2), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["kernel"])
    assert kernel.shape == (3, 1, 2, 3, 4)
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    sd = state_dict_from_jax({"c": variables["params"]})
    assert tuple(sd["c.weight"].shape) == (4, 3, 3, 1, 2)
    tconv = torch.nn.Conv3d(3, 4, (3, 1, 2), bias=False)
    tconv.weight.data.copy_(sd["c.weight"])
    with torch.no_grad():
        got = tconv(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(
            0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(KeyError, match="3-D kernel"):
        state_dict_from_jax({"c": {"kernel": np.zeros((3, 2, 2))}})


@pytest.fixture(scope="module")
def nets():
    jnet = JNet.from_genotype(GENO, **CFG)
    b = _batch(2)
    variables = jax.jit(lambda k, b: jnet.init(k, b, None, False))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in b.items()})
    variables = _randomized(variables)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    return jnet, variables, sd


def test_found_net_state_dict_maps_one_to_one(nets):
    _, _, sd = nets
    tnet = FoundSkeletonImageNet.from_genotype(GENO, **CFG)
    assert set(sd) == set(tnet.state_dict())
    assert tnet.used == (1, 3, 5)  # index 8 is the first cell's output
    assert tuple(sd["rgbnet.cnn.layer2_0.conv2.weight"].shape) == (
        128, 128, 3, 3, 3)


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_found_net_logits_match(nets, fused):
    """Full backbone widths on a 2-frame 32x32 clip and a 32-frame
    skeleton, a ragged batch (the padded row masked); the fused-eval CPU
    path runs the found-cell kernel's plain version."""
    jnet, variables, sd = nets
    b = _batch(3, valid=2, seed=5)
    want = np.asarray(jax.jit(lambda v, b: jnet.apply(v, b, None, False))(
        variables, {k: jnp.asarray(v) for k, v in b.items()}))
    tnet = FoundSkeletonImageNet.from_genotype(GENO, fused_eval=fused, **CFG)
    tnet.load_state_dict(sd)
    reset_launches()
    with torch.no_grad():
        got = tnet.eval()({k: torch.from_numpy(v) for k, v in b.items()})
    assert LAUNCHES["found_cell"] == 0  # the CPU never launches the kernel
    np.testing.assert_allclose(got.numpy(), want, **NET_TOL)
