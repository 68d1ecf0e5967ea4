"""The port's NTU search against the JAX package.

* Data: ``NTUDataset(train_transform=True)`` batches (the random temporal
  crop of every sample, from its own seed) and ``aug_crop_select``'s draws,
  byte for byte, on synthetic files both packages write from one seed.
* Metrics: ``accuracy_counts`` and ``topk_accuracy``.
* ``SearchableSkeletonImageNet``: a JAX net (C=8, L=4, two steps of two
  inner steps, node multiplier 2, 2-frame 32x32 clips, batch 4) with its
  BatchNorm statistics, affines and biases shifted, carried over with
  ``state_dict_from_jax`` / ``arch_from_jax``: every key maps one to one,
  eval-mode logits agree within 1e-4 in fp32 and train-mode ones within
  1e-4 in fp64, and two weight steps and one arch step, in fp64, agree at
  ``test_torch_port_search.py``'s tolerances (arch rtol 5e-3 / atol 5e-6,
  BatchNorm statistics 1e-4; the trained parameters within 1e-6) with the
  frozen backbones and reshape layers unmoved.
* The loop's accuracy mode: train -> test rows, ``Acc:`` lines, a tie that
  re-saves the best snapshot.
* The search CLI's refusals and device rule.

fp32 on the CPU. Dropout is off on both sides (flax's through an
``intercept_methods`` hook, the port's at rate 0): the attention op's
dropout has a fixed rate of 0.1 whatever ``drpt`` is.
"""
import json
import logging
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmnas_tpu.data import ntu as jdata
from bmnas_tpu.data.synthetic import make_ntu_synthetic as jmake
from bmnas_tpu.models.ntu import SearchableSkeletonImageNet as JNet
from bmnas_tpu.models.supernet import init_arch_params as j_init_arch
from bmnas_tpu_torch.cli.common import _stage_seed
from bmnas_tpu_torch.data import ntu as tdata
from bmnas_tpu_torch.data.synthetic import make_ntu_synthetic as tmake
from bmnas_tpu_torch.models.ntu import (
    NTU_SEARCH_FROZEN_PREFIXES,
    SearchableSkeletonImageNet,
)
from bmnas_tpu_torch.search import bilevel as tb
from bmnas_tpu_torch.utils.convert import arch_from_jax, state_dict_from_jax

CFG = dict(C=8, L=4, steps=2, multiplier=2, node_steps=2, node_multiplier=2,
           num_input_nodes=8, num_keep_edges=2, num_outputs=6, drpt=0.0)
B, FRAMES, HW = 4, 2, 32
KEYS = ("alphas", "betas", "gammas")
# two subjects of train_exp (1, 8), dev (2, 5) and test (3, 6); 100-frame
# skeletons, so that the crop keeps 64-99 of them from a random start
SYNTH = dict(n_videos_per_subject=3, subjects=(1, 8, 2, 5, 3, 6),
             num_actions=6, hw=16, frames=9, ske_frames=100, seed=5)


def _no_dropout(next_fn, args, kwargs, context):
    if isinstance(context.module, nn.Dropout):
        return args[0]
    return next_fn(*args, **kwargs)


def _shifted(variables, seed=0):
    rng = np.random.RandomState(seed)

    def shift(path, a):
        a = np.asarray(a)
        if path[-1].key == "kernel":
            return a
        return a + rng.rand(*a.shape).astype(np.float32) * 0.1
    return jax.tree_util.tree_map_with_path(
        shift, jax.tree_util.tree_map(np.asarray, dict(variables)))


def _batch(seed, valid=B):
    """uint8 clips and skeletons of a batch, zero past ``valid``."""
    rng = np.random.RandomState(seed)
    b = {"image": rng.randint(0, 256, (B, FRAMES, HW, HW, 3)).astype(
             np.uint8),
         "skeleton": rng.randn(B, 32, 25, 2, 3).astype(np.float32) * 0.1,
         "label": rng.randint(0, 6, (B,)).astype(np.int32),
         "mask": (np.arange(B) < valid).astype(np.float32)}
    for k in ("image", "skeleton", "label"):
        b[k][valid:] = 0
    return b


def _t(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# data and metrics

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ntu_train")
    jmake(str(root / "jax"), **SYNTH)
    tmake(str(root / "port"), **SYNTH)
    return root


@pytest.mark.parametrize("epoch", [0, 1])
def test_train_batches_match_jax_bytes(data, epoch):
    """Two epochs' seeds of the search's train phase (as the CLIs make
    them), a batch of 4 and a ragged one of 2: every array the same bytes
    and dtype as the JAX package's."""
    seed = 2 * 1000003 + epoch * 131 + _stage_seed("train")
    kw = dict(vid_len=(8, 32), num_workers=2, train_transform=True)
    want = list(jdata.NTUDataset(str(data / "jax"), "train_exp", **kw)
                .batches(4, shuffle=True, seed=seed))
    got = list(tdata.NTUDataset(str(data / "port"), "train_exp", **kw)
               .batches(4, shuffle=True, seed=seed))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[1]["mask"].tolist() == [1, 1, 0, 0]


def test_train_transform_crops(data):
    """The crop changes the sample, and a different seed another way."""
    kw = dict(vid_len=(8, 32), num_workers=1)
    plain = tdata.NTUDataset(str(data / "port"), "train_exp", **kw)
    crop = tdata.NTUDataset(str(data / "port"), "train_exp",
                            train_transform=True, **kw)
    a, b, c = (plain.load_sample(0, 1), crop.load_sample(0, 1),
               crop.load_sample(0, 2))
    assert a["image"].shape == b["image"].shape == (8, 16, 16, 3)
    assert not np.array_equal(a["skeleton"], b["skeleton"])
    assert not np.array_equal(b["skeleton"], c["skeleton"])
    assert np.array_equal(plain.load_sample(0, 7)["skeleton"],
                          a["skeleton"])  # no crop: the seed is unused


@pytest.mark.parametrize("n_rgb,ske_frames", [(9, 100), (24, 40), (0, 70),
                                              (5, 1)])
def test_aug_crop_select_draws_match(n_rgb, ske_frames):
    ske = np.random.RandomState(0).randn(3, ske_frames, 25, 2).astype(
        np.float32)
    if ske_frames == 1:
        ske = ske[:, 0, 0, 0]  # a 1-D skeleton is left alone
    for seed in range(5):
        jr, tr = (np.random.RandomState(seed) for _ in range(2))
        want_idx, want_ske = jdata.aug_crop_select(n_rgb, ske, jr)
        got_idx, got_ske = tdata.aug_crop_select(n_rgb, ske, tr)
        np.testing.assert_array_equal(got_idx, want_idx)
        np.testing.assert_array_equal(got_ske, want_ske)
        assert tr.randint(0, 2**31) == jr.randint(0, 2**31)  # same draws
        rgb = np.arange(max(n_rgb, 1) * 2).reshape(-1, 2)[:n_rgb]
        if n_rgb:
            np.testing.assert_array_equal(
                tdata.aug_crop(rgb, ske, np.random.RandomState(seed))[0],
                jdata.aug_crop(rgb, ske, np.random.RandomState(seed))[0])


def test_accuracy_metrics_match_jax():
    from bmnas_tpu.utils import metrics as jm
    from bmnas_tpu_torch.utils import metrics as tm
    rng = np.random.RandomState(3)
    logits = rng.randn(7, 6).astype(np.float32)
    logits[2, 4] = logits[2, 1] = 9.0  # a tie goes to the first
    labels = rng.randint(0, 6, (7,)).astype(np.int32)
    labels[2] = 1
    mask = np.array([1, 1, 1, 1, 1, 0, 0], np.float32)
    for m in (mask, None):
        want = jm.accuracy_counts(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        got = tm.accuracy_counts(torch.from_numpy(logits),
                                 torch.from_numpy(labels),
                                 None if m is None else torch.from_numpy(m))
        assert set(got) == set(want)
        for k in want:
            assert float(got[k]) == float(want[k]), k
    assert tm.topk_accuracy(logits, labels, (1, 3, 5)) == \
        jm.topk_accuracy(logits, labels, (1, 3, 5))
    assert tm.topk_accuracy(torch.from_numpy(logits),
                            torch.from_numpy(labels), (2,)) == \
        jm.topk_accuracy(logits, labels, (2,))
    meter = tm.AvgrageMeter()
    meter.update(2.0, 3)
    meter.update(4.0)
    assert (meter.avg, meter.sum, meter.cnt) == (2.5, 10.0, 4)


# ---------------------------------------------------------------------------
# the searchable net and its steps

@pytest.fixture(scope="module")
def nets():
    """(flax model, its shifted variables, JAX arch, the port's
    state_dict)."""
    jnet = JNet(**CFG)
    arch = j_init_arch(jax.random.PRNGKey(1), CFG["steps"],
                       CFG["num_input_nodes"], CFG["node_steps"])
    k = jax.random.PRNGKey(0)
    # eager: compiling the 3D ResNet takes longer than running it
    variables = _shifted(jnet.init({"params": k, "dropout": k}, _batch(0),
                                   arch, True))
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    return jnet, variables, arch, sd


def _port(sd):
    net = SearchableSkeletonImageNet(**CFG)
    net.load_state_dict(sd)  # strict: no missing or unexpected key
    for m in net.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    return net


def test_state_dict_maps_every_key(nets):
    _, _, arch, sd = nets
    net = SearchableSkeletonImageNet(**CFG)
    assert set(sd) == set(net.state_dict())
    assert "reshape_7.BatchNorm_0.running_var" in sd
    assert "fusion_net.cell.step_node_1.NodeMixedOp_1.ScaledDotAttn_0." \
        "LayerNorm2D_0.weight" in sd
    tarch = arch_from_jax(arch)
    assert tuple(tarch["betas"].shape) == (2, 5, 2)
    assert tuple(tarch["gammas"].shape) == (2, 2, 4)


def test_eval_logits_match(nets):
    """A ragged batch (the padded rows masked) in eval mode, on the
    running statistics, fp32."""
    jnet, variables, arch, sd = nets
    batch = _batch(1, valid=3)
    want = jnet.apply(variables, batch, arch, False)
    with torch.no_grad():
        got = _port(sd).eval()(_t(batch), arch_from_jax(arch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_train_logits_match_in_fp64(nets):
    """The same ragged batch in train mode (every BatchNorm on the batch's
    statistics), both sides in fp64 (the JAX net's taps and normalized clip
    stay fp32, as in its code): within 1e-4.

    Why fp64: in fp32 the two sides part by up to 5e-3 on logits of order
    1, and the port is the closer of the two to an fp64 run (2e-4 against
    5e-3). At 32x32 the ResNet's last stage normalizes each channel over 8
    values, which amplifies rounding, and flax's BatchNorm takes the
    variance as E[x^2] - E[x]^2 (``use_fast_variance``) where the port
    takes it about the mean."""
    jnet, variables, arch, sd = nets
    batch = _batch(1, valid=3)
    b64 = dict(batch, skeleton=batch["skeleton"].astype(np.float64),
               mask=batch["mask"].astype(np.float64))
    with jax.enable_x64():
        jnet64 = JNet(backbone_dtype=jnp.float64, **CFG)
        v64, a64 = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), (variables, dict(arch)))
        with nn.intercept_methods(_no_dropout):
            want, _ = jax.jit(lambda v, b, a: jnet64.apply(
                v, b, a, True, rngs={"dropout": jax.random.PRNGKey(9)},
                mutable=["batch_stats"]))(v64, b64, a64)
        want = np.asarray(want)
    assert want.dtype == np.float64
    net = _port(sd).double().train()
    with torch.no_grad():
        got = net(_t(b64), {k: v.double()
                            for k, v in arch_from_jax(arch).items()})
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _counts(logits, labels, mask):
    from bmnas_tpu_torch.cli.ntu import counts_fn
    return counts_fn(logits, labels, mask)


def _f64(batch):
    return dict(batch, skeleton=batch["skeleton"].astype(np.float64),
                mask=batch["mask"].astype(np.float64))


def test_bilevel_trajectory_matches(nets):
    """Two weight steps (the first batch ragged) and one arch step from the
    same weights, both sides in fp64 (see
    ``test_train_logits_match_in_fp64``; in fp32 the train-mode forwards
    part by rounding, and Adam turns that into steps of a learning rate):
    the arch tensors within rtol 5e-3 / atol 5e-6 of JAX's, the BatchNorm
    statistics (the frozen backbones' too: they run in train mode) within
    1e-4 (1.1e-5 at most, measured), the trained parameters, which move by
    about 1e-3 a step, within 1e-6 (3.2e-7 at most), and the backbones and
    the reshape layers, which the NTU search leaves out of its optimizer,
    unmoved on both sides."""
    from bmnas_tpu.search import bilevel as jb
    _, variables, arch, sd = nets
    etas = [1e-3, 9e-4]
    train_bs = [_f64(_batch(11, valid=3)), _f64(_batch(12))]
    dev_b = _f64(_batch(13))

    with jax.enable_x64():
        jnet = JNet(backbone_dtype=jnp.float64, **CFG)

        def apply_fn(vs, batch, a, train, rngs, mutable):
            if mutable:
                return jnet.apply(vs, batch, a, train, rngs=rngs,
                                  mutable=mutable)
            return jnet.apply(vs, batch, a, train)

        params, stats, jarch = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (variables["params"], variables["batch_stats"], dict(arch)))
        w_tx = jb.make_weight_optimizer(
            jb.make_param_labels(params, NTU_SEARCH_FROZEN_PREFIXES),
            weight_decay=3e-4)
        arch_tx = jb.make_arch_optimizer(3e-4, 1e-3)
        state = jb.TrainState(
            params=params, batch_stats=stats, arch=jarch,
            opt_w=w_tx.init(params), opt_arch=arch_tx.init(jarch),
            rng=jax.random.PRNGKey(7), step=jnp.asarray(0, jnp.int32))
        fns = jb.build_step_functions(
            apply_fn, jb.cross_entropy, lambda l, y, m: {}, w_tx, arch_tx,
            donate=False, frozen_prefixes=NTU_SEARCH_FROZEN_PREFIXES)
        with nn.intercept_methods(_no_dropout):
            for b, eta in zip(train_bs, etas):
                state, _ = fns.weight_step(state, b, np.float64(eta))
            state, _ = fns.arch_step(state, dev_b)
        state = jax.tree_util.tree_map(np.asarray, state)

    net = _port(sd).double()
    tb.freeze(net, NTU_SEARCH_FROZEN_PREFIXES)
    tarch = {k: v.double().detach().requires_grad_()
             for k, v in arch_from_jax(arch).items()}
    tstate = tb.TrainState(
        model=net, arch=tarch,
        opt_w=tb.make_weight_optimizer(net, NTU_SEARCH_FROZEN_PREFIXES, 3e-4),
        opt_arch=tb.make_arch_optimizer(tarch, 3e-4, 1e-3))
    tfns = tb.build_step_functions(tb.cross_entropy, _counts)
    for b, eta in zip(train_bs, etas):
        counts = tfns.weight_step(tstate, _t(b), eta)
        assert float(counts["valid"]) == float(b["mask"].sum())
    tfns.arch_step(tstate, _t(dev_b))

    for k in KEYS:
        assert state.arch[k].dtype == np.float64
        np.testing.assert_allclose(tarch[k].detach().numpy(), state.arch[k],
                                   rtol=5e-3, atol=5e-6, err_msg=k)
    want_sd = state_dict_from_jax(state.params, state.batch_stats)
    got_sd = net.state_dict()
    trained = 0
    for k, v in want_sd.items():
        if "num_batches" in k:
            continue
        if "running" not in k and k.split(".")[0] in \
                NTU_SEARCH_FROZEN_PREFIXES:
            assert torch.equal(got_sd[k], sd[k].double()), k
            np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), k)
            continue
        if "running" in k:
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
        else:
            assert not torch.equal(got_sd[k], sd[k].double()), k  # trained
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
            trained += 1
    assert trained > 0
    assert {n.split(".")[0] for n, p in net.named_parameters()
            if p.requires_grad} == {"fusion_net", "central_classifier"}


# ---------------------------------------------------------------------------
# the loop in accuracy mode

class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fusion_net = torch.nn.Linear(2, 2)


def _loop_run(tmp_path, task, status, correct):
    """Two epochs of ``run_training`` on stand-in steps: every batch counts
    ``correct[phase]`` of its 4 rows correct; each weight step moves the
    one parameter. Returns (result, log text, metrics rows, best dir)."""
    from bmnas_tpu_torch.genotype import Genotype, StepGenotype
    from bmnas_tpu_torch.search import loop
    from bmnas_tpu_torch.search.scheduler import LRCosineAnnealingScheduler
    from bmnas_tpu_torch.utils.experiment import create_exp_dir, setup_logger
    save = create_exp_dir(str(tmp_path / f"{task}-{status}"))
    logger = setup_logger(save)
    model = _Tiny()
    geno = Genotype(edges=[("skip", 0), ("skip", 1)], concat=[2],
                    steps=[StepGenotype([("skip", 0), ("skip", 1)], ["Sum"],
                                        [2])])

    def counts(phase):
        return {"correct": torch.tensor(float(correct[phase])),
                "loss_sum": torch.tensor(2.0), "valid": torch.tensor(4.0)}

    def weight_step(state, batch, eta):
        with torch.no_grad():
            state.model.fusion_net.weight.add_(1.0)
        return counts(batch["phase"])
    fns = tb.StepFunctions(
        weight_step=weight_step,
        arch_step=lambda st, b: counts(b["phase"]),
        eval_step=lambda st, b: counts(b["phase"]))
    phases = ("train", "dev", "test")
    state = tb.TrainState(model=model, arch=None, opt_w=None, opt_arch=None)

    class Args:
        pass
    args = Args()
    args.save = save

    class NoPlot:
        def plot(self, *a, **k):
            pass
    result = loop.run_training(
        task=task, status=status, fns=fns, state=state,
        scheduler=LRCosineAnnealingScheduler(1e-3, 1e-6, 1, 2, 1),
        loaders={p: (lambda e, p=p: [{"phase": p}]) for p in phases},
        dataset_sizes={p: 4 for p in phases}, num_epochs=2, metric="acc",
        f1_type="weighted", args=args, logger=logger, plotter=NoPlot(),
        genotype_fn=lambda st: geno)
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            h.flush()
    with open(os.path.join(save, "log.txt")) as f:
        text = f.read()
    with open(os.path.join(save, "metrics.jsonl")) as f:
        rows = [json.loads(r) for r in f]
    return result, text, rows, os.path.join(save, "best")


def test_loop_ntu_eval_phases_and_tie(tmp_path):
    """NTU found retraining: train -> test every epoch, accuracy rows and
    lines, and the equal test accuracy of epoch 1 re-saves the best
    snapshot (``>=``), so it holds epoch 1's weights."""
    from bmnas_tpu_torch.utils.checkpoint import load_model
    (best, geno, _), text, rows, best_dir = _loop_run(
        tmp_path, "ntu", "eval", {"train": 3, "test": 2})
    assert [(r["epoch"], r["phase"]) for r in rows] == [
        (0, "train"), (0, "test"), (1, "train"), (1, "test")]
    assert all(r["metric_name"] == "acc" for r in rows)
    assert [r["metric"] for r in rows] == [0.75, 0.5, 0.75, 0.5]
    assert "train Loss: 0.5000 Acc: 0.7500" in text
    assert "test Loss: 0.5000 Acc: 0.5000" in text
    assert "Current best test accuracy: 0.5, at training epoch: 1" in text
    assert best == 0.5 and geno is not None
    assert float(load_model(os.path.join(
        best_dir, "best_test_model.pt"))["fusion_net.weight"][0, 0]) > 1.0
    assert os.path.exists(os.path.join(best_dir, "best_test_genotype.pkl"))


def test_loop_mmimdb_keeps_first_of_a_tie(tmp_path):
    """MM-IMDB keeps a best only when it is strictly better (``>``); its
    found runs have a dev phase that trains."""
    _, text, rows, _ = _loop_run(tmp_path, "mmimdb", "eval",
                                 {"train": 3, "dev": 1, "test": 2})
    assert [r["phase"] for r in rows] == ["train", "dev", "test"] * 2
    assert "Current best test accuracy: 0.5, at training epoch: 0" in text


def test_loop_ntu_search_tie(tmp_path):
    """NTU search: train -> dev; a tie on dev re-saves the best."""
    (best, _, _), text, rows, best_dir = _loop_run(
        tmp_path, "ntu", "search", {"train": 1, "dev": 4})
    assert [r["phase"] for r in rows] == ["train", "dev"] * 2
    assert best == 1.0
    assert "dev Loss: 0.5000 Acc: 1.0000" in text
    assert "Current best dev accuracy: 1.0, at training epoch: 1" in text
    assert os.path.exists(os.path.join(best_dir, "best_genotype.pkl"))


# ---------------------------------------------------------------------------
# the search CLI's refusals

@pytest.mark.parametrize("flags", [
    ["--unrolled"], ["--steps_per_dispatch", "2"], ["--device_data_cache"],
    ["--bf16_backbone"], ["--data_backend", "grain"], ["--profile_dir", "x"],
    ["--parallel"], ["--device_cache_budget_gb", "5"],
    ["--h2d_streams", "2"]], ids=lambda f: f[0])
def test_unported_flags_are_refused(flags, tmp_path, monkeypatch):
    from bmnas_tpu_torch.cli.ntu import main_search
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit, match=f"{' '.join(flags[:1 + (
            flags[0] == '--data_backend')])}: not ported yet "
                                         r"\(ROADMAP.md Queue 1 item"):
        main_search(["--datadir", str(tmp_path), "--device", "cpu", *flags])
    assert os.listdir(tmp_path) == []


def test_search_flags_have_the_jax_defaults():
    from bmnas_tpu.cli.ntu import parse_search_args as jparse
    from bmnas_tpu_torch.cli.ntu import parse_search_args
    want, got = vars(jparse([])), vars(parse_search_args([]))
    for k, v in want.items():
        assert got[k] == v, k
    assert got["device"] is None


def test_search_raises_without_cuda_unless_cpu_asked(tmp_path, monkeypatch):
    from bmnas_tpu_torch.cli.ntu import main_search
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_search(["--datadir", str(tmp_path)])
    assert not os.path.exists("final_exp")
