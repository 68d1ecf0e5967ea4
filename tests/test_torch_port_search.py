"""The port's MM-IMDB search against the JAX package.

A JAX ``SearchableImageTextNet`` (C=8, L=4, 64x64 images, batch 4) is
initialised, its BatchNorm statistics and affines shifted, and its weights
and arch params carried into the port with ``state_dict_from_jax`` and
``arch_from_jax``. Inputs are made with numpy from a seed; fp32 on the CPU.
Dropout is off on both sides: flax's by an ``intercept_methods`` hook, the
port's by eval-mode (single forwards) or zero-rate (step functions, which
put the model in train mode) Dropout modules. Tolerances are those of
``tests/test_full_model_parity.py``.
"""
import glob
import json
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmnas_tpu.models.mmimdb import SearchableImageTextNet as JNet
from bmnas_tpu.models.supernet import init_arch_params as j_init_arch
from bmnas_tpu_torch.models.mmimdb import (
    MMIMDB_FROZEN_PREFIXES,
    SearchableImageTextNet,
)
from bmnas_tpu_torch.models.supernet import (
    derive_genotype_from_arch,
    init_arch_params,
)
from bmnas_tpu_torch.ops.kernels import LAUNCHES
from bmnas_tpu_torch.search import bilevel as tb
from bmnas_tpu_torch.utils.convert import arch_from_jax, state_dict_from_jax

CFG = dict(C=8, L=4, steps=2, multiplier=2, node_steps=1, node_multiplier=1,
           num_input_nodes=6, num_keep_edges=2, num_outputs=23, drpt=0.1)
B, HW = 4, 64
KEYS = ("alphas", "betas", "gammas")


def _no_dropout(next_fn, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fn(*args, **kwargs)


def _shifted(variables, seed=0):
    """BatchNorm statistics, norm affines and biases shifted by U(0, 0.1);
    dense and conv kernels keep their init scale."""
    rng = np.random.RandomState(seed)

    def shift(path, a):
        a = np.asarray(a)
        if path[-1].key == "kernel":
            return a
        return a + rng.rand(*a.shape).astype(np.float32) * 0.1
    return jax.tree_util.tree_map_with_path(
        shift, jax.tree_util.tree_map(np.asarray, dict(variables)))


def _batch(seed, valid=B):
    rng = np.random.RandomState(seed)
    b = {"image": rng.randn(B, HW, HW, 3).astype(np.float32),
         "text": rng.randn(B, 300).astype(np.float32),
         "label": (rng.rand(B, 23) < 0.3).astype(np.float32),
         "mask": np.zeros((B,), np.float32)}
    b["mask"][:valid] = 1.0
    for k in ("image", "text", "label"):  # a zero-padded final batch
        b[k][valid:] = 0.0
    return b


def _t(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


@pytest.fixture(scope="module")
def nets():
    """(flax model, its variables, JAX arch, the port's state_dict)."""
    jnet = JNet(**CFG)
    arch = j_init_arch(jax.random.PRNGKey(1), CFG["steps"],
                       CFG["num_input_nodes"], CFG["node_steps"])
    variables = jnet.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(2)},
        _batch(0), arch, True)
    variables = _shifted(variables)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    return jnet, variables, arch, sd


def _port(sd, dropout=None):
    net = SearchableImageTextNet(**CFG)
    net.load_state_dict(sd)  # strict: no missing or unexpected key
    if dropout is not None:
        for m in net.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = dropout
    return net


def test_state_dict_from_jax_maps_every_key(nets):
    _, _, arch, sd = nets
    net = SearchableImageTextNet(**CFG)
    missing, unexpected = net.load_state_dict(sd, strict=False)
    assert not missing and not unexpected
    assert "fusion_net.cell.step_node_1.NodeMixedOp_0.LinearGLU_0." \
        "BatchNorm_0.running_var" in sd
    tarch = arch_from_jax(arch)
    for k in KEYS:
        assert tarch[k].requires_grad and tarch[k].is_leaf
        np.testing.assert_array_equal(tarch[k].detach().numpy(),
                                      np.asarray(arch[k]))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_logits_match(nets, train):
    jnet, variables, arch, sd = nets
    batch = _batch(1)
    net = _port(sd)
    if train:
        with nn.intercept_methods(_no_dropout):
            want, _ = jnet.apply(variables, batch, arch, True,
                                 rngs={"dropout": jax.random.PRNGKey(9)},
                                 mutable=["batch_stats"])
        net.train()
        for m in net.modules():
            if isinstance(m, torch.nn.Dropout):
                m.eval()
    else:
        want = jnet.apply(variables, batch, arch, False)
        net.eval()
    with torch.no_grad():
        got = net(_t(batch), arch_from_jax(arch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=1e-4)


def test_arch_gradients_match(nets):
    """d loss / d {alpha, beta, gamma} on one train-mode dev batch."""
    from bmnas_tpu.search.bilevel import bce_with_logits as jbce
    jnet, variables, arch, sd = nets
    batch = _batch(5, valid=3)

    def arch_loss(a):
        with nn.intercept_methods(_no_dropout):
            logits, _ = jnet.apply(variables, batch, a, True,
                                   rngs={"dropout": jax.random.PRNGKey(9)},
                                   mutable=["batch_stats"])
        return jbce(logits, jnp.asarray(batch["label"]),
                    jnp.asarray(batch["mask"]))

    want = jax.grad(arch_loss)(arch)
    net = _port(sd, dropout=0.0).train()
    tarch = arch_from_jax(arch)
    tbatch = _t(batch)
    loss = tb.bce_with_logits(net(tbatch, tarch), tbatch["label"],
                              tbatch["mask"])
    got = torch.autograd.grad(loss, [tarch[k] for k in KEYS])
    for k, g in zip(KEYS, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=2e-3, atol=1e-6, err_msg=k)


def _counts(logits, labels, mask):
    from bmnas_tpu_torch.cli.mmimdb import counts_fn
    return counts_fn(logits, labels, mask)


def test_bilevel_trajectory_matches(nets):
    """Three weight steps and three arch steps from the same weights: the
    arch tensors stay within rtol 5e-3 / atol 5e-6 of JAX's, the derived
    genotype is the same, and so are the BatchNorm statistics (1e-4). The
    train batch is a padded final batch (one zero row, masked)."""
    from bmnas_tpu.search import bilevel as jb
    jnet, variables, arch, sd = nets
    etas = [1e-3, 9e-4, 8e-4]
    train_b, dev_b = _batch(11, valid=3), _batch(12)

    def apply_fn(vs, batch, a, train, rngs, mutable):
        if mutable:
            return jnet.apply(vs, batch, a, train, rngs=rngs,
                              mutable=mutable)
        return jnet.apply(vs, batch, a, train)

    labels = jb.make_param_labels(variables["params"],
                                  MMIMDB_FROZEN_PREFIXES)
    w_tx = jb.make_weight_optimizer(labels, weight_decay=1e-4)
    arch_tx = jb.make_arch_optimizer(3e-4, 1e-3)
    jarch = {k: jnp.asarray(v) for k, v in arch.items()}
    state = jb.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        arch=jarch, opt_w=w_tx.init(variables["params"]),
        opt_arch=arch_tx.init(jarch), rng=jax.random.PRNGKey(7),
        step=jnp.asarray(0, jnp.int32))
    fns = jb.build_step_functions(apply_fn, jb.bce_with_logits,
                                  lambda l, y, m: {}, w_tx, arch_tx,
                                  donate=False,
                                  frozen_prefixes=MMIMDB_FROZEN_PREFIXES)
    with nn.intercept_methods(_no_dropout):
        for eta in etas:
            state, _ = fns.weight_step(state, train_b, np.float32(eta))
            state, _ = fns.arch_step(state, dev_b)
            jax.tree_util.tree_map(np.asarray, state.arch)

    net = _port(sd, dropout=0.0)
    tb.freeze(net, MMIMDB_FROZEN_PREFIXES)
    tarch = arch_from_jax(arch)
    tstate = tb.TrainState(
        model=net, arch=tarch,
        opt_w=tb.make_weight_optimizer(net, MMIMDB_FROZEN_PREFIXES, 1e-4),
        opt_arch=tb.make_arch_optimizer(tarch, 3e-4, 1e-3))
    tfns = tb.build_step_functions(tb.bce_with_logits, _counts)
    for eta in etas:
        counts = tfns.weight_step(tstate, _t(train_b), eta)
        assert float(counts["valid"]) == 3.0
        tfns.arch_step(tstate, _t(dev_b))

    for k in KEYS:
        np.testing.assert_allclose(tarch[k].detach().numpy(),
                                   np.asarray(state.arch[k]),
                                   rtol=5e-3, atol=5e-6, err_msg=k)
    cfg = (CFG["steps"], CFG["multiplier"], CFG["num_input_nodes"],
           CFG["node_steps"], CFG["node_multiplier"])
    from bmnas_tpu.models.supernet import derive_genotype_from_arch as jder
    assert derive_genotype_from_arch(tarch, *cfg) == jder(state.arch, *cfg)
    want_sd = state_dict_from_jax(state.params, state.batch_stats)
    got_sd = net.state_dict()
    for k, v in want_sd.items():
        if "running" in k:
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=k)


def test_steps_touch_only_their_own_tensors(nets):
    """A weight step moves the trainable parameters and leaves the arch
    and the frozen backbones; an arch step moves the arch and leaves every
    parameter; neither leaves a ``.grad`` behind."""
    _, _, arch, sd = nets
    torch.manual_seed(0)
    net = _port(sd)
    tb.freeze(net, MMIMDB_FROZEN_PREFIXES)
    tarch = arch_from_jax(arch)
    state = tb.TrainState(
        model=net, arch=tarch,
        opt_w=tb.make_weight_optimizer(net, MMIMDB_FROZEN_PREFIXES, 1e-4),
        opt_arch=tb.make_arch_optimizer(tarch, 3e-4, 1e-3))
    fns = tb.build_step_functions(tb.bce_with_logits, _counts)

    def snap():
        return ({n: p.detach().clone() for n, p in net.named_parameters()},
                {k: v.detach().clone() for k, v in tarch.items()})

    def moved(before, after):
        return {k for k in before if not torch.equal(before[k], after[k])}

    p0, a0 = snap()
    fns.weight_step(state, _t(_batch(3)), 1e-3)
    p1, a1 = snap()
    assert not moved(a0, a1)
    changed = moved(p0, p1)
    assert changed and all(n.split(".")[0] not in MMIMDB_FROZEN_PREFIXES
                           for n in changed)
    assert {n for n, p in net.named_parameters() if p.requires_grad} \
        == changed
    fns.arch_step(state, _t(_batch(4)))
    p2, a2 = snap()
    assert moved(a1, a2) == set(KEYS) and not moved(p1, p2)
    assert all(p.grad is None for p in net.parameters())
    assert all(a.grad is None for a in tarch.values())
    before = LAUNCHES["node_mixed"]
    counts = fns.eval_step(state, _t(_batch(6, valid=2)))
    assert LAUNCHES["node_mixed"] == before  # CPU eval: the composite
    assert float(counts["valid"]) == 2.0 and not net.training


def test_scheduler_matches_jax_over_two_restarts():
    from bmnas_tpu.search.scheduler import LRCosineAnnealingScheduler as J
    from bmnas_tpu_torch.search.scheduler import LRCosineAnnealingScheduler
    j, t = J(1e-3, 1e-6, 1, 2, 3), LRCosineAnnealingScheduler(1e-3, 1e-6, 1,
                                                               2, 3)
    want = [j.step() for _ in range(15)]
    got = [t.step() for _ in range(15)]
    assert got == want
    assert t.Ti == j.Ti == 4.0  # restarted twice: Ti 1 -> 2 -> 4
    assert t.state() == j.state()


def test_fixed_scheduler_matches_jax():
    from bmnas_tpu.search.scheduler import FixedScheduler as J
    from bmnas_tpu_torch.search.scheduler import FixedScheduler
    j, t = J(3e-4), FixedScheduler(3e-4)
    assert [t.step() for _ in range(3)] == [j.step() for _ in range(3)]
    assert t.eta == j.eta == 3e-4
    t.load_state(J(5e-4).state())
    assert t.state() == {"lr": 5e-4} and t.step() == 5e-4


def test_scheduler_load_state_resumes_jax_schedule():
    """A schedule restored from the JAX package's state mid-period (one
    restart done) goes on exactly as the JAX one does."""
    from bmnas_tpu.search.scheduler import LRCosineAnnealingScheduler as J
    from bmnas_tpu_torch.search.scheduler import LRCosineAnnealingScheduler
    j = J(1e-3, 1e-6, 1, 2, 3)
    for _ in range(5):
        j.step()
    t = LRCosineAnnealingScheduler(1e-3, 1e-6, 1, 2, 3)
    t.load_state(j.state())
    assert [t.step() for _ in range(10)] == [j.step() for _ in range(10)]
    assert t.state() == j.state()


def test_init_arch_params_shapes_and_scale():
    arch = init_arch_params(torch.Generator().manual_seed(0), 2, 6, 1)
    assert tuple(arch["alphas"].shape) == (13, 2)
    assert tuple(arch["betas"].shape) == (2, 2, 2)
    assert tuple(arch["gammas"].shape) == (2, 1, 4)
    for v in arch.values():
        assert v.is_leaf and v.requires_grad
        assert float(v.detach().abs().max()) < 1e-2
    again = init_arch_params(torch.Generator().manual_seed(0), 2, 6, 1)
    assert all(torch.equal(arch[k], again[k]) for k in KEYS)


def test_checkpoint_round_trip_with_arch(nets, tmp_path):
    from bmnas_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        load_model,
        save_model,
    )
    _, _, arch, sd = nets
    net = _port(sd)
    tarch = arch_from_jax(arch)
    path = str(tmp_path / "best_model.pt")
    save_model(path, net, tarch)
    got_sd, got_arch = load_checkpoint(path)
    assert set(got_sd) == set(net.state_dict())
    assert load_model(path).keys() == got_sd.keys()
    for k in KEYS:
        assert torch.equal(got_arch[k], tarch[k].detach())
    save_model(path, net)
    assert load_checkpoint(path)[1] is None


def test_main_search_cpu(tmp_path, monkeypatch):
    """One epoch of ``main_search --device cpu`` on synthetic data with
    ragged final batches: every artifact is written, and the genotype
    pickle loads in the JAX package."""
    from bmnas_tpu.genotype import load_genotype as jload
    from bmnas_tpu_torch.cli.mmimdb import main_search
    from bmnas_tpu_torch.data.synthetic import make_mmimdb_synthetic
    from bmnas_tpu_torch.utils.checkpoint import load_checkpoint
    monkeypatch.chdir(tmp_path)
    make_mmimdb_synthetic("data", image_hw=(64, 64), seed=1, correlated=True,
                          counts={"train": 6, "dev": 5, "test": 0})
    best_f1, geno = main_search([
        "--datadir", "data", "--epochs", "1", "--batchsize", "4",
        "--C", "8", "--L", "4", "--num_workers", "2", "--device", "cpu"])
    (exp,) = glob.glob("final_exp/mmimdb/search-EXP-*")
    with open(os.path.join(exp, "log.txt")) as f:
        log = f.read()
    for line in ("train Loss:", "dev Loss:", "Fusion Model Params:",
                 "Current best dev weighted F1:", "Searching complete"):
        assert line in log, line
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        rows = [json.loads(r) for r in f]
    assert [r["phase"] for r in rows] == ["train", "dev"]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert 0.0 < best_f1 <= 1.0
    assert jload(os.path.join(exp, "best", "best_genotype.pkl")) == geno
    assert glob.glob(os.path.join(exp, "architectures", "epoch_0*"))
    sd, arch = load_checkpoint(os.path.join(exp, "best", "best_model.pt"))
    SearchableImageTextNet(**dict(CFG, num_outputs=23)).load_state_dict(sd)
    assert tuple(arch["gammas"].shape) == (2, 1, 4)


@pytest.mark.parametrize("flags", [
    ["--unrolled"], ["--resume", "x"], ["--steps_per_dispatch", "2"],
    ["--device_data_cache"], ["--bf16_backbone"],
    ["--data_backend", "grain"], ["--profile_dir", "x"], ["--parallel"]],
    ids=lambda f: f[0])
def test_unported_flags_are_refused(flags, tmp_path, monkeypatch):
    """Each flag is refused before the exp dir exists. ``--resume`` is
    ported now: a path that does not exist is refused as a missing
    checkpoint (``tests/test_torch_port_found.py`` resumes real ones)."""
    from bmnas_tpu_torch.cli.mmimdb import main_search
    monkeypatch.chdir(tmp_path)
    match = ("--resume: checkpoint not found" if flags[0] == "--resume"
             else "not ported yet.*ROADMAP.md")
    with pytest.raises(SystemExit, match=match):
        main_search(["--datadir", str(tmp_path), "--device", "cpu", *flags])
    assert not os.path.exists("final_exp")


def test_search_raises_without_cuda_unless_cpu_asked(tmp_path, monkeypatch):
    from bmnas_tpu_torch.cli.mmimdb import main_search
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_search(["--datadir", str(tmp_path)])
    assert not os.path.exists("final_exp")
