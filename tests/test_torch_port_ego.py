"""The port's Ego models against the JAX package: the 3D ResNeXt (a grouped
bottleneck, both stems, the taps), ``normalize_uint8_ego``, the grouped
5-D kernel mapping and the found task net over two full ResNeXt-101s.

Each flax module is initialised, its BatchNorm statistics, affines and
biases randomized, and its weights carried into the port with
``state_dict_from_jax``; the same inputs, made with numpy from a seed, go
through both in eval mode. fp32 on the CPU. Tolerances: 1e-5 for a block
and the ResNeXt taps (the two frameworks sum the convolutions in different
orders), 1e-4 for the found net's logits, as for NTU's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmnas_tpu.genotype import Genotype, StepGenotype
from bmnas_tpu.models.ego import FoundRGBDepthNet as JNet
from bmnas_tpu.models.ego import normalize_uint8_ego as jnormalize
from bmnas_tpu.models.resnext import ResNeXt3D as JResNeXt
from bmnas_tpu.models.resnext import ResNeXtBottleneck as JBlock
from bmnas_tpu_torch.models.ego import FoundRGBDepthNet, normalize_uint8_ego
from bmnas_tpu_torch.models.resnext import (
    ResNeXt3D,
    ResNeXtBottleneck,
    get_depth_model,
    get_rgb_model,
)
from bmnas_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from bmnas_tpu_torch.utils.convert import state_dict_from_jax

TOL = dict(rtol=1e-5, atol=1e-5)
NET_TOL = dict(rtol=1e-4, atol=1e-4)
# two found cells of three chained inner steps (each step reads the one
# before it) and a node multiplier of 3, the Ego defaults: every inner op,
# the 3-way out-conv, RGB and depth taps, and an outer edge that reads the
# first cell's output (index 8)
GENO = Genotype(
    edges=[("skip", 1), ("skip", 6), ("skip", 3), ("skip", 8)],
    concat=[8, 9],
    steps=[StepGenotype([("skip", 0), ("skip", 1), ("skip", 1), ("skip", 2),
                         ("skip", 2), ("skip", 3)],
                        ["LinearGLU", "ScaleDotAttn", "Sum"], [2, 3, 4]),
           StepGenotype([("skip", 1), ("skip", 0), ("skip", 2), ("skip", 0),
                         ("skip", 3), ("skip", 1)],
                        ["ConcatFC", "Sum", "ScaleDotAttn"], [2, 3, 4])],
)
CFG = dict(C=8, L=4, steps=2, multiplier=2, node_steps=3, node_multiplier=3,
           num_input_nodes=8, num_keep_edges=2, num_outputs=6, drpt=0.0)
# narrow ResNeXts built directly: 4 groups, one or two blocks a stage
NARROW = dict(layers=(1, 1, 2, 1), planes=(32, 64, 64, 128), cardinality=4)


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


def _batch(n, valid=None, seed=1, frames=4, hw=32):
    rng = np.random.RandomState(seed)
    b = {"rgb": rng.randint(0, 256, (n, frames, hw, hw, 3)).astype(np.uint8),
         "depth": rng.randint(0, 256, (n, frames, hw, hw, 1)).astype(
             np.uint8),
         "mask": np.zeros((n,), np.float32)}
    b["mask"][:n if valid is None else valid] = 1.0
    return b


# (in channels, stride, downsample, the JAX block's dense_grouped, output
# shape) on a (2, 5, 7, 9) clip
BLOCKS = {
    "grouped": (24, 2, True, False, (2, 3, 4, 5, 256)),
    # the JAX package's TPU form of the grouped convolution, a dense one
    # with a block-diagonal kernel, holds the same parameter: it loads into
    # the port's grouped convolution and gives the same map
    "dense": (24, 2, True, True, (2, 3, 4, 5, 256)),
    # no projection: the residual is the stream itself
    "identity": (256, 1, False, False, (2, 5, 7, 9, 256)),
}


@pytest.mark.parametrize("block", list(BLOCKS))
def test_grouped_bottleneck_matches(block):
    """A bottleneck with 4 groups of 4 channels on an odd-sized clip,
    strided with a downsampling projection, or not."""
    c_in, stride, downsample, dense, shape = BLOCKS[block]
    x = np.random.RandomState(2).randn(2, 5, 7, 9, c_in).astype(np.float32)
    jmod = JBlock(planes=128, cardinality=4, stride=stride,
                  downsample=downsample, dense_grouped=dense)
    variables = _randomized(jax.jit(lambda k, x: jmod.init(k, x, False))(
        jax.random.PRNGKey(3), jnp.asarray(x)), seed=3)
    want = np.asarray(jmod.apply(variables, jnp.asarray(x), False))
    tmod = _port(ResNeXtBottleneck(c_in, 128, cardinality=4, stride=stride,
                                   downsample=downsample), variables)
    assert tuple(tmod.conv2.weight.shape) == (16, 4, 3, 3, 3)
    assert tmod.conv2.groups == 4
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(
            0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("stem", ["rgb", "depth"])
def test_resnext_taps_match(stem):
    """Narrow nets of either stem (RGB: 3 channels, (3, 7, 7) padded
    (1, 3, 3); depth: 1 channel, (7, 7, 7) padded (3, 3, 3); stride
    (1, 2, 2) and the -inf-padded 3^3/2 max pool) on a 5-frame 32x32 clip:
    every tap's shape and values, the pooled vector and the logits."""
    c_in, kt = (3, 3) if stem == "rgb" else (1, 7)
    clip = np.random.RandomState(4).randn(2, 5, 32, 32, c_in).astype(
        np.float32)
    jmod = JResNeXt(num_outputs=6, in_channels=c_in, stem_kernel_t=kt,
                    **NARROW)
    variables = _randomized(jax.jit(lambda k, x: jmod.init(k, x, False))(
        jax.random.PRNGKey(5), jnp.asarray(clip)), seed=5)
    want = jmod.apply(variables, jnp.asarray(clip), False)
    tmod = _port(ResNeXt3D(6, in_channels=c_in, stem_kernel_t=kt, **NARROW),
                 variables)
    assert tuple(tmod.conv1.weight.shape) == (64, c_in, kt, 7, 7)
    with torch.no_grad():
        got = tmod(torch.from_numpy(clip))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want] == [
        (2, 2, 4, 4, 128), (2, 1, 2, 2, 128), (2, 1, 1, 1, 256), (2, 256),
        (2, 6)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_bf16_net_keeps_an_fp32_residual_stream():
    """Cast to bf16 but for its BatchNorms (as the bf16 server casts it), a
    bottleneck takes the fp32 residual stream, runs its branch in bf16 and
    returns the stream in fp32; the net's taps come back in bf16, close to
    the fp32 net's."""
    torch.manual_seed(0)
    net = ResNeXt3D(6, **NARROW).eval()
    clip = torch.from_numpy(np.random.RandomState(9).randn(
        2, 5, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        want = net(clip)
        net.to(torch.bfloat16)
        for m in net.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.float()
        stream = torch.randn(2, 128, 1, 2, 2)
        block = net.layer3_1  # no projection: the stream is the residual
        assert block.conv1.weight.dtype == torch.bfloat16
        assert block(stream).dtype == torch.float32
        got = net(clip)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert float((g.float() - w).abs().max()) <= 0.05 * float(
            w.abs().max())


def test_model_factories_keep_the_jax_attributes():
    """get_rgb_model and get_depth_model at the full ResNeXt-101 widths
    (on the meta device: no weights)."""
    for build, c_in, kt in ((get_rgb_model, 3, 3), (get_depth_model, 1, 7)):
        net = build(83, device="meta")
        assert (net.layers, net.planes, net.cardinality, net.in_channels,
                net.stem_kernel_t) == ((3, 4, 23, 3), (128, 256, 512, 1024),
                                       32, c_in, kt)
        assert tuple(net.layer3_0.conv2.weight.shape) == (512, 16, 3, 3, 3)
        assert tuple(net.fc.weight.shape) == (83, 2048)


def test_normalize_uint8_ego_matches():
    b = _batch(3, valid=2)
    want = jnormalize(jnp.asarray(b["rgb"]), jnp.asarray(b["depth"]),
                      jnp.asarray(b["mask"]))
    got = normalize_uint8_ego(torch.from_numpy(b["rgb"]),
                              torch.from_numpy(b["depth"]),
                              torch.from_numpy(b["mask"]))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
        assert not g[2].any()  # the padded row stays zero
    assert got[0][0].min() < 0 <= got[1][0].min()  # the mean is RGB's only
    f = torch.zeros(1, 2, 4, 4, 3), torch.zeros(1, 2, 4, 4, 1)
    assert all(a is b for a, b in zip(normalize_uint8_ego(*f), f))


def test_grouped_kernel_mapping():
    """A flax (3, 3, 3, cpg, F) grouped kernel becomes Conv3d(groups)'s
    (F, cpg, 3, 3, 3), group-major on both sides, against flax's conv."""
    import flax.linen as fnn
    x = np.random.RandomState(6).randn(2, 4, 5, 6, 8).astype(np.float32)
    conv = fnn.Conv(12, (3, 3, 3), padding=1, feature_group_count=4,
                    use_bias=False)
    variables = conv.init(jax.random.PRNGKey(7), jnp.asarray(x))
    assert variables["params"]["kernel"].shape == (3, 3, 3, 2, 12)
    want = np.asarray(conv.apply(variables, jnp.asarray(x)))
    sd = state_dict_from_jax({"c": variables["params"]})
    assert tuple(sd["c.weight"].shape) == (12, 2, 3, 3, 3)
    tconv = torch.nn.Conv3d(8, 12, 3, padding=1, groups=4, bias=False)
    tconv.weight.data.copy_(sd["c.weight"])
    with torch.no_grad():
        got = tconv(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(
            0, 2, 3, 4, 1).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.fixture(scope="module")
def nets():
    """The JAX net (fused_eval, its found cells through the Pallas kernel
    in interpret mode) at the full ResNeXt-101 widths, its randomized
    weights, the port's state dict of them, and its logits on a ragged
    batch of 4-frame 32x32 clips."""
    jnet = JNet.from_genotype(GENO, fused_eval=True, **CFG)
    b = {k: jnp.asarray(v) for k, v in _batch(2).items()}
    variables = _randomized(jax.jit(
        lambda k, b: jnet.init(k, b, None, False))(jax.random.PRNGKey(0), b))
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    batch = _batch(3, valid=2, seed=5)
    want = np.asarray(jax.jit(lambda v, b: jnet.apply(v, b, None, False))(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    return sd, batch, want


def test_found_net_state_dict_maps_one_to_one(nets):
    sd, _, _ = nets
    tnet = FoundRGBDepthNet.from_genotype(GENO, device="meta", **CFG)
    assert set(sd) == set(tnet.state_dict())
    assert tnet.used == (1, 3, 6)  # index 8 is the first cell's output
    for key, shape in (("rgb_net.conv1.weight", (64, 3, 3, 7, 7)),
                       ("depth_net.conv1.weight", (64, 1, 7, 7, 7)),
                       ("rgb_net.layer2_0.conv2.weight", (256, 8, 3, 3, 3)),
                       ("depth_net.layer4_0.downsample_conv.weight",
                        (2048, 1024, 1, 1, 1)),
                       ("depth_net.layer4_0.downsample_bn.running_var",
                        (2048,)),
                       ("rgb_net.fc.weight", (6, 2048)),
                       ("fusion_net.cell.step_node_0.Dense_0.weight",
                        (8, 24))):
        assert tuple(sd[key].shape) == shape, key


@pytest.mark.parametrize("fused", [False, True], ids=["eager", "fused"])
def test_found_net_logits_match(nets, fused):
    """Both full backbones on a ragged batch (the padded row masked)
    against the JAX net's fused-eval logits; the port's fused-eval CPU path
    runs the found-cell kernel's plain version. The net stays in eval mode
    in its backbones even when put in train mode."""
    sd, batch, want = nets
    tnet = FoundRGBDepthNet.from_genotype(GENO, fused_eval=fused, **CFG)
    tnet.load_state_dict(sd)
    tnet.train()
    assert not tnet.rgb_net.training and not tnet.depth_net.training
    reset_launches()
    with torch.no_grad():
        got = tnet.eval()({k: torch.from_numpy(v) for k, v in batch.items()})
    assert LAUNCHES["found_cell"] == 0  # the CPU never launches the kernel
    assert got.shape == want.shape == (3, 6)
    np.testing.assert_allclose(got.numpy(), want, **NET_TOL)


def test_unhostable_cell_refused():
    """A found cell the kernel cannot host (an inner ``fc_relu`` edge) is
    refused when the net is built for CUDA, before any CUDA memory is
    taken (so here, on a host without CUDA, too), and when it is built for
    the kernel on the CPU (``fused_eval``)."""
    bad = Genotype(edges=GENO.edges, concat=GENO.concat,
                   steps=[StepGenotype([("fc_relu", 0)] + [("skip", 1)] * 5,
                                       ["Sum"] * 3, [2, 3, 4])] * 2)
    for kw in (dict(device="cuda"), dict(fused_eval=True, device="meta")):
        with pytest.raises(ValueError, match="cannot host"):
            FoundRGBDepthNet.from_genotype(bad, **kw, **CFG)
