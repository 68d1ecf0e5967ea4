"""The port's MM-IMDB found retraining, test-only and --resume.

Steps against the JAX package: a JAX ``FoundImageTextNet`` (C=8, L=4,
32x32 images, batch 4) is initialised, its BatchNorm statistics, norm
affines and biases shifted, and its weights carried into the port with
``state_dict_from_jax``. Inputs are made with numpy from a seed; fp32 on the
CPU. Dropout is off on both sides: flax's by an ``intercept_methods`` hook,
the port's by zero-rate Dropout modules (the weight step puts the model in
train mode).

CLI round trip and resume, on ``make_mmimdb_synthetic(correlated=True)``
data through the port's own entry points on the CPU: search, found
retraining, test-only, then ``cli.serve`` on the eval dir; a resumed search
and a resumed found run against uninterrupted ones, bit for bit.
"""
import glob
import json
import os

import flax.linen as nn
import jax
import numpy as np
import pytest
import torch

from bmnas_tpu.genotype import Genotype, StepGenotype
from bmnas_tpu.models.mmimdb import FoundImageTextNet as JNet
from bmnas_tpu_torch.cli.mmimdb import counts_fn
from bmnas_tpu_torch.data.synthetic import make_mmimdb_synthetic
from bmnas_tpu_torch.models.mmimdb import FoundImageTextNet as TNet
from bmnas_tpu_torch.ops.kernels import LAUNCHES
from bmnas_tpu_torch.search import bilevel as tb
from bmnas_tpu_torch.utils.convert import state_dict_from_jax

GENO = Genotype(
    edges=[("skip", 0), ("skip", 4), ("skip", 2), ("skip", 5)],
    concat=[6, 7],
    steps=[StepGenotype([("skip", 0), ("skip", 1)], ["ScaleDotAttn"], [2]),
           StepGenotype([("skip", 1), ("skip", 0)], ["LinearGLU"], [2])],
)
CFG = dict(C=8, L=4, steps=2, multiplier=2, node_steps=1, node_multiplier=1,
           num_input_nodes=6, num_keep_edges=2, num_outputs=23, drpt=0.1)
B, HW = 4, 32
TINY = ["--batchsize", "4", "--C", "8", "--L", "4", "--num_workers", "2",
        "--device", "cpu"]


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


@pytest.fixture(scope="module", params=["bmnas", "mfas"])
def nets(request):
    """(variant, flax model, its variables, the port's state_dict). mfas is
    the ablation node with a BatchNorm."""
    variant = request.param
    jnet = JNet.from_genotype(GENO, node_variant=variant, **CFG)
    variables = jnet.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(2)},
        _batch(0), None, True)
    variables = _shifted(variables)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    return variant, jnet, variables, sd


def _port(variant, sd):
    net = TNet.from_genotype(GENO, node_variant=variant, **CFG)
    net.load_state_dict(sd)  # strict: no missing or unexpected key
    for m in net.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return net


def test_found_train_logits_match(nets):
    """One train-mode forward (BatchNorm on batch statistics) within
    1e-4."""
    variant, jnet, variables, sd = nets
    batch = _batch(1)
    with nn.intercept_methods(_no_dropout):
        want, _ = jnet.apply(variables, batch, None, True,
                             rngs={"dropout": jax.random.PRNGKey(9)},
                             mutable=["batch_stats"])
    net = _port(variant, sd).train()
    with torch.no_grad():
        got = net(_t(batch), None)  # arch is taken and ignored
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_found_weight_steps_match(nets):
    """Three found weight steps (every parameter trains, the VGG-19 and the
    MaxOut MLP included) from the same weights, the first batch a padded
    final batch.

    After the first step the BatchNorm running statistics match within
    1e-5 (abs + rel), and all but 1e-3 of the 20 million weights within
    1e-6. After the third, the eval-mode logits (of order 1) match within
    rtol 1e-2 / atol 1e-2. Why not the search test's 5e-3 / 5e-6: Adam
    divides each update by the root of its second moment, so a weight whose
    gradient is near zero moves by about +-eta either way, by the sign of
    its rounding, which differs between XLA and PyTorch on the CPU. One
    step flips about 2e-4 of the weights (most in the VGG-19, whose
    32x32-image taps leave many gradients near zero); the flips change the
    next steps' activations and gradients, and after three steps the
    logits differ by up to 2.5e-3. A wrong learning rate, decay, mask or a
    frozen backbone moves every weight instead."""
    from bmnas_tpu.search import bilevel as jb
    variant, jnet, variables, sd = nets
    etas = [1e-3, 9e-4, 8e-4]
    train_bs = [_batch(11, valid=3), _batch(12), _batch(13)]
    probe = _batch(14)

    def apply_fn(vs, batch, a, train, rngs, mutable):
        if mutable:
            return jnet.apply(vs, batch, a, train, rngs=rngs,
                              mutable=mutable)
        return jnet.apply(vs, batch, a, train)

    w_tx = jb.make_weight_optimizer(
        jb.make_param_labels(variables["params"], ()), weight_decay=1e-4)
    state = jb.TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        arch=None, opt_w=w_tx.init(variables["params"]), opt_arch=None,
        rng=jax.random.PRNGKey(7), step=np.int32(0))
    fns = jb.build_step_functions(apply_fn, jb.bce_with_logits,
                                  lambda l, y, m: {}, w_tx, None,
                                  donate=False)
    net = _port(variant, sd)
    tstate = tb.TrainState(model=net, arch=None,
                           opt_w=tb.make_weight_optimizer(net, (), 1e-4),
                           opt_arch=None)
    tfns = tb.build_step_functions(tb.bce_with_logits, counts_fn)

    for i, (b, eta) in enumerate(zip(train_bs, etas)):
        with nn.intercept_methods(_no_dropout):
            state, _ = fns.weight_step(state, b, np.float32(eta))
        counts = tfns.weight_step(tstate, _t(b), eta)
        assert float(counts["valid"]) == float(b["mask"].sum())
        if i:
            continue
        want_sd = state_dict_from_jax(state.params, state.batch_stats)
        got_sd = net.state_dict()
        off = total = 0
        for k, v in want_sd.items():
            if "running" in k:
                np.testing.assert_allclose(got_sd[k].numpy(), v.numpy(),
                                           rtol=1e-5, atol=1e-5, err_msg=k)
            elif "num_batches" not in k:
                assert not torch.equal(got_sd[k], sd[k]), k  # it trained
                off += int(((got_sd[k] - v).abs() > 1e-6).sum())
                total += v.numel()
        assert off <= 1e-3 * total, (off, total)

    want = jnet.apply({"params": state.params,
                       "batch_stats": state.batch_stats}, probe, None, False)
    before = LAUNCHES["found_cell"]
    eval_counts = tfns.eval_step(tstate, _t(probe))
    assert LAUNCHES["found_cell"] == before  # CPU eval: no kernel launch
    assert float(eval_counts["valid"]) == B and not net.training
    with torch.no_grad():
        got = net(_t(probe))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-2,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def search_exp(tmp_path_factory):
    """(work dir, data dir, search exp dir) of one search epoch."""
    from bmnas_tpu_torch.cli.mmimdb import main_search
    work = tmp_path_factory.mktemp("found_cli")
    data = str(work / "data")
    make_mmimdb_synthetic(data, image_hw=(HW, HW), seed=1, correlated=True,
                          counts={"train": 6, "dev": 5, "test": 7})
    cwd = os.getcwd()
    os.chdir(work)
    try:
        main_search(["--datadir", data, "--epochs", "1", *TINY])
    finally:
        os.chdir(cwd)
    (exp,) = glob.glob(str(work / "final_exp/mmimdb/search-EXP-*"))
    return work, data, exp


def test_found_and_test_only_round_trip(search_exp, capsys):
    """search -> found retraining -> test-only -> serve: the artifacts of
    each, and the serve CLI's weighted F1 on the eval dir equals test-only's
    (same weights, same test split) within 1e-6."""
    from bmnas_tpu.genotype import load_genotype as jload
    from bmnas_tpu_torch.cli.mmimdb import main_found
    from bmnas_tpu_torch.cli.serve import main_serve
    _, data, exp = search_exp
    f1 = main_found(["--datadir", data, "--search_exp_dir", exp,
                     "--epochs", "1", "--save", "RT", *TINY])
    assert np.isfinite(f1) and 0.0 < f1 <= 1.0
    (eval_dir,) = glob.glob(os.path.join(exp, "eval-RT-*"))
    with open(os.path.join(eval_dir, "log.txt")) as f:
        log = f.read()
    for line in ("train Loss:", "dev Loss:", "test Loss:",
                 "Current best test weighted F1:", "Final model weighted F1:"):
        assert line in log, line
    with open(os.path.join(eval_dir, "metrics.jsonl")) as f:
        rows = [json.loads(r) for r in f]
    assert [r["phase"] for r in rows] == ["train", "dev", "test"]
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert rows[-1]["metric"] == f1
    best = os.path.join(eval_dir, "best")
    assert os.path.exists(os.path.join(best, "best_test_model.pt"))
    assert jload(os.path.join(best, "best_test_genotype.pkl")) == jload(
        os.path.join(exp, "best", "best_genotype.pkl"))
    assert glob.glob(os.path.join(eval_dir, "architectures", "epoch_0*"))
    assert os.path.exists(os.path.join(eval_dir, "checkpoint.pt"))

    f1_test = main_found(["--datadir", data, "--eval_exp_dir", eval_dir,
                          *TINY])
    assert np.isfinite(f1_test)
    (test_dir,) = glob.glob(os.path.join(eval_dir, "test-*"))
    with open(os.path.join(test_dir, "log.txt")) as f:
        assert "test Loss:" in f.read()
    capsys.readouterr()
    served = main_serve(["--task", "mmimdb", "--eval_exp_dir", eval_dir,
                         "--datadir", data, *TINY])
    assert served["model"].endswith("best_test_model.pt")
    assert served["samples"] == 7
    assert served["value"] == pytest.approx(f1_test, abs=1e-6)


def _load_ck(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_same(a, b, where="checkpoint"):
    """Equal, bit for bit: tensors by ``torch.equal``, containers item by
    item."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, (where, a, b)


def _rows(exp_dir):
    with open(os.path.join(exp_dir, "metrics.jsonl")) as f:
        return [json.loads(r) for r in f]


def _resume_matches(run, glob_of):
    """Two epochs in one run against one epoch plus --resume for the
    second, dropout on: the final checkpoints (weights, BatchNorm
    statistics, arch, both optimizer states, scheduler, best metrics, RNG
    states) and the second epoch's metrics rows are identical."""
    run(["--epochs", "2", "--save", "WHOLE"])
    run(["--epochs", "1", "--save", "HALF"])
    (half,) = glob_of("HALF")
    run(["--epochs", "2", "--save", "RESUMED",
         "--resume", os.path.join(half, "checkpoint.pt")])
    (whole,), (resumed,) = glob_of("WHOLE"), glob_of("RESUMED")
    a = _load_ck(os.path.join(whole, "checkpoint.pt"))
    b = _load_ck(os.path.join(resumed, "checkpoint.pt"))
    assert a["extra"]["epoch"] == 1
    _assert_same(a, b)
    assert [r for r in _rows(whole) if r["epoch"] == 1] == _rows(resumed)
    with open(os.path.join(resumed, "log.txt")) as f:
        assert "continuing at epoch 1" in f.read()
    return a


def test_search_resume_is_bit_exact(search_exp, monkeypatch):
    from bmnas_tpu_torch.cli.mmimdb import main_search
    work, data, _ = search_exp
    monkeypatch.chdir(work)

    def run(flags):
        main_search(["--datadir", data, *TINY, *flags])
    ck = _resume_matches(run, lambda s: glob.glob(
        f"final_exp/mmimdb/search-{s}-*"))
    assert ck["arch"] is not None and ck["opt_arch"] is not None
    assert ck["extra"]["scheduler"]["iteration_counter"] > 0


def test_found_resume_is_bit_exact(search_exp, monkeypatch):
    from bmnas_tpu_torch.cli.mmimdb import main_found
    work, data, exp = search_exp
    monkeypatch.chdir(work)

    def run(flags):
        main_found(["--datadir", data, "--search_exp_dir", exp, *TINY,
                    *flags])
    ck = _resume_matches(run, lambda s: glob.glob(
        os.path.join(exp, f"eval-{s}-*")))
    assert ck["arch"] is None and ck["opt_arch"] is None
    assert ck["extra"]["best_test_metric"] > 0


@pytest.mark.parametrize("cli", ["search", "found"])
def test_resume_of_missing_checkpoint_fails_first(cli, tmp_path,
                                                  monkeypatch):
    """A --resume path that does not exist fails before any exp dir is
    created, as a missing --datadir does."""
    from bmnas_tpu_torch.cli import mmimdb
    monkeypatch.chdir(tmp_path)
    main = {"search": mmimdb.main_search, "found": mmimdb.main_found}[cli]
    extra = [] if cli == "search" else ["--search_exp_dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="--resume: checkpoint not found"):
        main(["--datadir", str(tmp_path), "--device", "cpu", *extra,
              "--resume", str(tmp_path / "nope.pt")])
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("cli", ["search", "found"])
@pytest.mark.parametrize("flags", [
    ["--unrolled"], ["--steps_per_dispatch", "2"], ["--bf16_backbone"],
    ["--profile_dir", "x"]], ids=lambda f: f[0])
def test_search_extras_still_refused(flags, cli, tmp_path, monkeypatch):
    from bmnas_tpu_torch.cli import mmimdb
    monkeypatch.chdir(tmp_path)
    main = {"search": mmimdb.main_search, "found": mmimdb.main_found}[cli]
    extra = [] if cli == "search" else ["--search_exp_dir", str(tmp_path)]
    with pytest.raises(SystemExit,
                       match="not ported yet.*ROADMAP.md Queue 1 item 3"):
        main(["--datadir", str(tmp_path), "--device", "cpu", *extra, *flags])
    assert os.listdir(tmp_path) == []


def test_found_needs_an_exp_dir():
    from bmnas_tpu_torch.cli.mmimdb import main_found
    with pytest.raises(SystemExit, match="one of --search_exp_dir / "
                                         "--eval_exp_dir is required"):
        main_found(["--device", "cpu"])


def test_found_raises_without_cuda_unless_cpu_asked(tmp_path, monkeypatch):
    from bmnas_tpu_torch.cli.mmimdb import main_found
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main_found(["--datadir", str(tmp_path),
                    "--search_exp_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []
