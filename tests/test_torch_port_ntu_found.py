"""The port's NTU found retraining, ablation nets, ``--remat`` and CLIs.

* ``NTUAblationNet``: each of the four ``--task_variant`` nets of the JAX
  package (C=8, L=4, 2-frame 32x32 clips, batch 4, BatchNorm statistics,
  affines and biases shifted) carried over with ``state_dict_from_jax``:
  every key maps one to one and the eval-mode logits agree within 1e-4.
* One found weight step of ``FoundSkeletonImageNet`` (every parameter
  trains, the 3D ResNet-50 and HCN included), both sides in fp64 (see
  ``test_torch_port_ntu_search.py::test_train_logits_match_in_fp64``), at
  ``test_torch_port_found.py``'s tolerances: BatchNorm statistics within
  1e-5, all but 1e-3 of the weights within 1e-6.
* ``--remat`` against no remat on the port: two found weight steps, the
  parameters and BatchNorm statistics within 1e-6; the rerun in the
  backward must leave the running statistics alone.
* The CLIs on the CPU at a tiny size (``tests/test_e2e_ntu.py``'s flags):
  search -> found -> test-only, ``--task_variant simple_concat``, and the
  refusals.

Dropout is off on both sides (flax's through an ``intercept_methods``
hook, the port's at rate 0).
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

from bmnas_tpu.genotype import Genotype, StepGenotype
from bmnas_tpu.models.ntu import FoundSkeletonImageNet as JFound
from bmnas_tpu.models.ntu import NTUAblationNet as JAbl
from bmnas_tpu_torch.models import inflated_resnet
from bmnas_tpu_torch.models.ntu import (
    NTU_TASK_VARIANTS,
    FoundSkeletonImageNet,
    NTUAblationNet,
)
from bmnas_tpu_torch.search import bilevel as tb
from bmnas_tpu_torch.utils.convert import state_dict_from_jax

B, FRAMES, HW = 4, 2, 32
ABL = dict(C=8, L=4, num_outputs=6, drpt=0.0)
CFG = dict(C=8, L=4, steps=2, multiplier=2, node_steps=2, node_multiplier=2,
           num_input_nodes=8, num_keep_edges=2, num_outputs=6, drpt=0.0)
# two found cells of two chained inner steps, node multiplier 2, an outer
# edge reading the first cell's output (8)
GENO = Genotype(
    edges=[("skip", 2), ("skip", 6), ("skip", 8), ("skip", 4)],
    concat=[8, 9],
    steps=[StepGenotype([("skip", 0), ("skip", 1), ("skip", 2), ("skip", 1)],
                        ["LinearGLU", "ScaleDotAttn"], [2, 3]),
           StepGenotype([("skip", 1), ("skip", 0), ("skip", 2), ("skip", 0)],
                        ["ConcatFC", "Sum"], [2, 3])],
)
TINY = ["--small_dataset", "--batchsize", "2", "--epochs", "1",
        "--C", "8", "--L", "4", "--num_outputs", "6",
        "--num_workers", "2", "--seed", "3", "--device", "cpu"]


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


def _f64(batch):
    return dict(batch, skeleton=batch["skeleton"].astype(np.float64),
                mask=batch["mask"].astype(np.float64))


def _zero_dropout(net):
    for m in net.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.p = 0.0
    return net


# ---------------------------------------------------------------------------
# the ablation nets

@pytest.mark.parametrize("variant", NTU_TASK_VARIANTS[1:])
def test_ablation_logits_match(variant):
    """Eval mode, a ragged batch, fp32."""
    jnet = JAbl(variant=variant, **ABL)
    # eager: compiling the 3D ResNet takes longer than running it
    variables = _shifted(jnet.init(jax.random.PRNGKey(0), _batch(0), None,
                                   False), seed=1)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    net = NTUAblationNet(variant=variant, **ABL)
    assert set(sd) == set(net.state_dict())
    net.load_state_dict(sd)
    batch = _batch(2, valid=3)
    want = jnet.apply(variables, batch, None, False)
    with torch.no_grad():
        got = net.eval()(_t(batch))
    assert got.shape == (B, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_ablation_net_refuses_unknown_variant():
    with pytest.raises(ValueError, match="unknown NTU task variant"):
        NTUAblationNet(variant="bmnas", **ABL)


# ---------------------------------------------------------------------------
# found retraining's weight step

@pytest.fixture(scope="module")
def found():
    """(the JAX found net's shifted variables, the port's state_dict)."""
    jnet = JFound.from_genotype(GENO, **CFG)
    k = jax.random.PRNGKey(0)
    variables = _shifted(jnet.init({"params": k, "dropout": k}, _batch(0),
                                   None, True))
    return variables, state_dict_from_jax(variables["params"],
                                          variables["batch_stats"])


def _port_found(sd, **kw):
    net = FoundSkeletonImageNet.from_genotype(GENO, **CFG, **kw)
    net.load_state_dict(sd)
    return _zero_dropout(net)


def test_found_weight_step_matches(found):
    """One weight step of the whole net from the same weights on a ragged
    batch, fp64 on both sides: BatchNorm statistics within 1e-5 (abs +
    rel) and all but 1e-3 of the 24 million weights within 1e-6, as in
    ``test_torch_port_found.py`` (Adam moves a weight whose gradient is
    near zero by about eta either way, by the sign of its rounding); every
    weight moved, the backbones' included."""
    from bmnas_tpu.search import bilevel as jb
    variables, sd = found
    batch = _f64(_batch(11, valid=3))
    with jax.enable_x64():
        jnet = JFound.from_genotype(GENO, backbone_dtype=jnp.float64, **CFG)

        def apply_fn(vs, b, a, train, rngs, mutable):
            if mutable:
                return jnet.apply(vs, b, a, train, rngs=rngs, mutable=mutable)
            return jnet.apply(vs, b, a, train)

        params, stats = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float64),
            (variables["params"], variables["batch_stats"]))
        w_tx = jb.make_weight_optimizer(jb.make_param_labels(params, ()),
                                        weight_decay=3e-4)
        state = jb.TrainState(params=params, batch_stats=stats, arch=None,
                              opt_w=w_tx.init(params), opt_arch=None,
                              rng=jax.random.PRNGKey(7),
                              step=jnp.asarray(0, jnp.int32))
        fns = jb.build_step_functions(apply_fn, jb.cross_entropy,
                                      lambda l, y, m: {}, w_tx, None,
                                      donate=False)
        with nn.intercept_methods(_no_dropout):
            state, _ = fns.weight_step(state, batch, np.float64(1e-3))
        state = jax.tree_util.tree_map(np.asarray, state)

    from bmnas_tpu_torch.cli.ntu import counts_fn
    net = _port_found(sd).double()
    tstate = tb.TrainState(model=net, arch=None,
                           opt_w=tb.make_weight_optimizer(net, (), 3e-4),
                           opt_arch=None)
    counts = tb.build_step_functions(tb.cross_entropy, counts_fn) \
        .weight_step(tstate, _t(batch), 1e-3)
    assert float(counts["valid"]) == 3.0
    want_sd = state_dict_from_jax(state.params, state.batch_stats)
    got_sd = net.state_dict()
    assert set(want_sd) == set(got_sd)
    off = total = 0
    for k, v in want_sd.items():
        if "running" in k:
            np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        elif "num_batches" not in k:
            assert not torch.equal(got_sd[k], sd[k].double()), k  # trained
            off += int(((got_sd[k] - v).abs() > 1e-6).sum())
            total += v.numel()
    assert total > 20_000_000 and off <= 1e-3 * total, (off, total)


# ---------------------------------------------------------------------------
# --remat

def test_remat_equals_no_remat(found, monkeypatch):
    """Two found weight steps with and without ``remat`` from the same
    weights: parameters and BatchNorm statistics within 1e-6. With remat
    each bottleneck runs twice a step (the forward and the backward's
    rerun), and the rerun must leave the running statistics alone: moved
    twice, a statistic ends about 0.09 x (batch - running) away."""
    from bmnas_tpu_torch.cli.ntu import counts_fn
    _, sd = found
    runs = {"n": 0}
    block = inflated_resnet.Bottleneck3D._block

    def counted(self, x):
        runs["n"] += 1
        return block(self, x)
    monkeypatch.setattr(inflated_resnet.Bottleneck3D, "_block", counted)
    fns = tb.build_step_functions(tb.cross_entropy, counts_fn)
    out, n_blocks = {}, 16
    for remat in (False, True):
        torch.manual_seed(0)
        net = _port_found(sd, remat=remat)
        state = tb.TrainState(model=net, arch=None,
                              opt_w=tb.make_weight_optimizer(net, (), 3e-4),
                              opt_arch=None)
        runs["n"] = 0
        for seed, eta in ((21, 1e-3), (22, 9e-4)):
            fns.weight_step(state, _t(_batch(seed, valid=3)), eta)
        assert runs["n"] == 2 * n_blocks * (2 if remat else 1), remat
        out[remat] = net.state_dict()
    for k, v in out[False].items():
        if v.is_floating_point():
            np.testing.assert_allclose(out[True][k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            assert torch.equal(out[True][k], v), k
    # eval and no-grad forwards take the blocks once, remat or not
    runs["n"] = 0
    with torch.no_grad():
        net.eval()(_t(_batch(23)))
    assert runs["n"] == n_blocks


# ---------------------------------------------------------------------------
# the CLIs on the CPU

@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from bmnas_tpu_torch.data.synthetic import make_ntu_synthetic
    root = tmp_path_factory.mktemp("ntu_cli")
    # subjects of train_exp (1, 8), dev (2, 5) and test (3, 6)
    return make_ntu_synthetic(str(root), n_videos_per_subject=2,
                              subjects=(1, 8, 2, 5, 3, 6), num_actions=6,
                              hw=32, frames=70)


def _rows(exp):
    with open(os.path.join(exp, "metrics.jsonl")) as f:
        return [json.loads(r) for r in f]


def test_search_found_test_only_round_trip(data_root, tmp_path, monkeypatch):
    """The three entry points on the CPU: the search writes the MM-IMDB
    CLIs' layout with accuracy rows and a genotype the JAX package loads;
    found retraining (``--remat``) trains and tests on train_val and test;
    test-only prints the retrained snapshot's accuracy, the same as the
    found run's last test row; ``--task_variant simple_concat`` trains the
    ablation net and writes no genotype."""
    from bmnas_tpu.genotype import load_genotype as jload
    from bmnas_tpu_torch.cli.ntu import main_found, main_search
    monkeypatch.chdir(tmp_path)
    common = ["--datadir", data_root, "--checkpointdir", str(tmp_path)]
    best_acc, geno = main_search(common + TINY)
    (exp,) = glob.glob("final_exp/ntu/search-EXP-*")
    with open(os.path.join(exp, "log.txt")) as f:
        log = f.read()
    for line in ("train Loss:", " Acc: ", "dev Loss:",
                 "Current best dev accuracy:", "using random init",
                 "Searching complete"):
        assert line in log, line
    rows = _rows(exp)
    assert [r["phase"] for r in rows] == ["train", "dev"]
    assert all(r["metric_name"] == "acc" and np.isfinite(r["loss"])
               for r in rows)
    assert 0.0 <= best_acc <= 1.0
    assert jload(os.path.join(exp, "best", "best_genotype.pkl")) == geno
    assert len(geno.steps[0].inner_steps) == 2
    assert os.path.exists(os.path.join(exp, "checkpoint.pt"))

    acc = main_found(common + TINY + ["--search_exp_dir", exp, "--steps",
                                      "2", "--remat"])
    (eval_dir,) = glob.glob(os.path.join(exp, "eval-EXP-*"))
    rows = _rows(eval_dir)
    assert [r["phase"] for r in rows] == ["train", "test"]
    assert acc == rows[-1]["metric"]
    for f in ("best_test_model.pt", "best_test_genotype.pkl"):
        assert os.path.exists(os.path.join(eval_dir, "best", f)), f

    got = main_found(common + TINY + ["--eval_exp_dir", eval_dir,
                                      "--steps", "2"])
    assert got == pytest.approx(acc, abs=1e-6)
    (test_dir,) = glob.glob(os.path.join(eval_dir, "test-EXP-*"))
    with open(os.path.join(test_dir, "log.txt")) as f:
        assert "test Loss: " in f.read()

    abl = main_found(common + TINY + ["--search_exp_dir", exp,
                                      "--task_variant", "simple_concat",
                                      "--save", "ABL"])
    (abl_dir,) = glob.glob(os.path.join(exp, "eval-ABL-*"))
    assert [r["phase"] for r in _rows(abl_dir)] == ["train", "test"]
    assert 0.0 <= abl <= 1.0
    assert os.listdir(os.path.join(abl_dir, "best")) == [
        "best_test_model.pt"]


@pytest.mark.parametrize("name", ["ske_cp", "rgb_cp", "imagenet_cp"])
def test_backbone_checkpoint_is_refused(name, tmp_path, monkeypatch):
    """A checkpoint under ``--checkpointdir`` is refused with ROADMAP.md
    item 8, before the exp dir exists; it is never ignored."""
    from bmnas_tpu_torch.cli.ntu import main_found, main_search, \
        parse_search_args
    monkeypatch.chdir(tmp_path)
    (tmp_path / "ck").mkdir()
    (tmp_path / "ck" / getattr(parse_search_args([]), name)).write_bytes(
        b"x")
    common = ["--datadir", str(tmp_path), "--checkpointdir",
              str(tmp_path / "ck"), "--device", "cpu"]
    match = r"not ported yet \(ROADMAP.md Queue 1 item 8"
    with pytest.raises(SystemExit, match=match):
        main_search(common)
    with pytest.raises(SystemExit, match=match):
        main_found(common + ["--search_exp_dir", str(tmp_path)])
    assert not os.path.exists("final_exp")
    assert sorted(os.listdir(tmp_path)) == ["ck"]


@pytest.mark.parametrize("flags", [
    ["--unrolled"], ["--bf16_backbone"], ["--device_data_cache"],
    ["--device_cache_budget_gb", "12"], ["--parallel"]], ids=lambda f: f[0])
def test_found_refuses_unported_flags(flags, tmp_path):
    from bmnas_tpu_torch.cli.ntu import main_found
    with pytest.raises(SystemExit, match=f"{flags[0]}: not ported yet "
                                         r"\(ROADMAP.md Queue 1 item"):
        main_found(["--datadir", str(tmp_path), "--device", "cpu",
                    "--search_exp_dir", str(tmp_path), *flags])
    assert os.listdir(tmp_path) == []


def test_found_flags_have_the_jax_defaults():
    from bmnas_tpu.cli.ntu import parse_found_args as jparse
    from bmnas_tpu_torch.cli.ntu import parse_found_args
    want, got = vars(jparse([])), vars(parse_found_args([]))
    for k, v in want.items():
        assert got[k] == v, k
    assert (got["steps"], got["epochs"], got["eta_max"], got["Ti"]) == (
        4, 50, 3e-4, 5)


def test_found_raises_without_cuda_unless_cpu_asked(tmp_path, monkeypatch):
    from bmnas_tpu_torch.cli.ntu import main_found
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for flag in ("--search_exp_dir", "--eval_exp_dir"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main_found(["--datadir", str(tmp_path), flag, str(tmp_path)])
    assert os.listdir(tmp_path) == []


def test_searchers_run_the_task_search(tmp_path, monkeypatch):
    """``NTUSearcher`` / ``MMIMDB_Searcher`` call their CLI's
    ``run_search`` on the device the args name."""
    from bmnas_tpu_torch import searchers
    from bmnas_tpu_torch.cli import mmimdb, ntu
    seen = []
    for mod in (ntu, mmimdb):
        monkeypatch.setattr(mod, "run_search",
                            lambda a, lg, d, mod=mod: seen.append(
                                (mod.__name__, d.type)) or (0.5, None))
    args = ntu.parse_search_args(["--device", "cpu"])
    assert searchers.NTUSearcher(args, None).search() == (0.5, None)
    assert searchers.MMIMDB_Searcher(args, None).search() == (0.5, None)
    assert seen == [("bmnas_tpu_torch.cli.ntu", "cpu"),
                    ("bmnas_tpu_torch.cli.mmimdb", "cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        searchers.NTUSearcher(ntu.parse_search_args([]), None)


def test_prepare_ntu_rescales_videos(tmp_path):
    """``prepare`` writes the 256x256 layout that ``NTUDataset`` reads and
    the id -> frame count pickle (OpenCV, a 5-frame 40x30 video)."""
    import pickle

    import cv2

    from bmnas_tpu_torch.data.ntu import load_video
    from bmnas_tpu_torch.data.prepare_ntu import prepare
    raw = tmp_path / "raw"
    raw.mkdir()
    name = "S001C001P001R001A001"
    out = cv2.VideoWriter(str(raw / f"{name}_rgb.avi"),
                          cv2.VideoWriter_fourcc(*"MJPG"), 30, (40, 30))
    for i in range(5):
        out.write(np.full((30, 40, 3), 40 * i, np.uint8))
    out.release()
    dst = prepare(str(raw), str(tmp_path / "out"), dim=16, num_workers=1)
    assert dst == str(tmp_path / "out" / "nturgb+d_rgb_16x16_30")
    with open(tmp_path / "out" / "video_lengths.pkl", "rb") as f:
        assert pickle.load(f) == {name: 5}
    clip = load_video(os.path.join(dst, f"{name}_rgb.avi"), vid_len=5)
    assert clip.shape == (5, 16, 16, 3) and clip.dtype == np.uint8
