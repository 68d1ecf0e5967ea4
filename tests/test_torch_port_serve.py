"""The port's found MM-IMDB net, server and serve CLI vs the JAX package.

A JAX ``FoundImageTextNet`` (C=8, L=4, 32x32 images) is initialised, its
BatchNorm statistics and affines randomized, and its weights carried into
the port with ``state_dict_from_jax``. Inputs are made with numpy from a
seed. fp32 on the CPU; logits agree within 1e-4.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmnas_tpu.data.synthetic import make_mmimdb_synthetic as jmake
from bmnas_tpu.genotype import Genotype, StepGenotype, save_genotype
from bmnas_tpu.models.mmimdb import FoundImageTextNet as JNet
from bmnas_tpu.utils.checkpoint import save_model as jsave
from bmnas_tpu_torch.data.synthetic import make_mmimdb_synthetic as tmake
from bmnas_tpu_torch.models.foundnet import FoundFusionNetwork
from bmnas_tpu_torch.models.mmimdb import FoundImageTextNet as TNet
from bmnas_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from bmnas_tpu_torch.serving import FoundNetServer
from bmnas_tpu_torch.utils.checkpoint import load_model, save_model
from bmnas_tpu_torch.utils.convert import state_dict_from_jax

GENO = Genotype(
    edges=[("skip", 0), ("skip", 4), ("skip", 2), ("skip", 5)],
    concat=[6, 7],
    steps=[StepGenotype([("skip", 0), ("skip", 1)], ["ScaleDotAttn"], [2]),
           StepGenotype([("skip", 1), ("skip", 0)], ["LinearGLU"], [2])],
)
CFG = dict(C=8, L=4, steps=2, multiplier=2, node_steps=1, node_multiplier=1,
           num_input_nodes=6, num_keep_edges=2, num_outputs=23, drpt=0.0)
TOL = dict(rtol=1e-4, atol=1e-4)


def _randomized(variables, seed=0):
    """BatchNorm statistics, norm affines and biases shifted by U(0, 0.1);
    dense and conv kernels keep their init scale (shifting all 16 VGG
    kernels would blow the activations up past what fp32 LayerNorm
    statistics resolve)."""
    rng = np.random.RandomState(seed)

    def shift(path, a):
        a = np.asarray(a)
        if path[-1].key == "kernel":
            return a
        return a + rng.rand(*a.shape).astype(np.float32) * 0.1
    return jax.tree_util.tree_map_with_path(
        shift, jax.tree_util.tree_map(np.asarray, dict(variables)))


def _batch(n, valid=None, seed=1):
    rng = np.random.RandomState(seed)
    b = {"image": rng.rand(n, 32, 32, 3).astype(np.float32),
         "text": rng.randn(n, 300).astype(np.float32),
         "label": (rng.rand(n, 23) < 0.2).astype(np.float32),
         "mask": np.zeros((n,), np.float32)}
    b["mask"][:n if valid is None else valid] = 1.0
    return b


@pytest.fixture(scope="module")
def nets():
    jnet = JNet.from_genotype(GENO, **CFG)
    b = _batch(2)
    variables = jnet.init(jax.random.PRNGKey(0),
                          {k: jnp.asarray(b[k]) for k in ("image", "text")},
                          None, False)
    variables = _randomized(variables)
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    tnet = TNet.from_genotype(GENO, **CFG)
    tnet.load_state_dict(sd)
    return jnet, variables, tnet.eval(), sd


def test_found_net_logits_match(nets):
    jnet, variables, tnet, _ = nets
    b = _batch(3)
    want = np.asarray(jnet.apply(
        variables, {k: jnp.asarray(b[k]) for k in ("image", "text")}, None,
        False))
    with torch.no_grad():
        got = tnet({k: torch.from_numpy(b[k]) for k in ("image", "text")})
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    with torch.no_grad():  # the fused-eval CPU path gives the same logits
        fused = TNet.from_genotype(GENO, fused_eval=True, **CFG)
        fused.load_state_dict(nets[3])
        got2 = fused.eval()({k: torch.from_numpy(b[k])
                             for k in ("image", "text")})
    np.testing.assert_allclose(got2.numpy(), want, **TOL)


def test_server_matches_jax_fused_server(nets, tmp_path):
    from bmnas_tpu.serving import FoundNetServer as JServer
    jnet, variables, _, sd = nets
    jserver = JServer(jnet, variables["params"], variables["batch_stats"],
                      fused=True)
    save_model(str(tmp_path / "m.pt"), sd)
    tserver = FoundNetServer(TNet.from_genotype(GENO, **CFG),
                             load_model(str(tmp_path / "m.pt")), fused=True,
                             device="cpu")
    reset_launches()
    for b in (_batch(4), _batch(4, valid=3, seed=2)):  # full, mask-trimmed
        want = jserver.predict(b)
        got = tserver.predict(b)
        assert got.shape == want.shape == (int(b["mask"].sum()), 23)
        np.testing.assert_allclose(got, want, **TOL)
    got = tserver.predict_stream([_batch(4), _batch(4, valid=1, seed=3)])
    assert got.shape == (5, 23)
    assert LAUNCHES["found_cell"] == 0  # the CPU never launches the kernel


@pytest.mark.parametrize("variant", ["bmnas", "darts", "mfas", "aoa",
                                     "two_head_attn"])
def test_node_variants_match(variant):
    from bmnas_tpu.models.foundnet import FoundFusionNetwork as JFusion
    from bmnas_tpu.models.foundnet import _freeze
    rng = np.random.RandomState(4)
    feats = [rng.randn(3, 4, 8).astype(np.float32) for _ in range(6)]
    kw = dict(steps=2, multiplier=2, num_input_nodes=6, num_keep_edges=2,
              node_steps=1, node_multiplier=1, C=8, L=4, drpt=0.0,
              node_variant=variant)
    jnet = JFusion(genotype=_freeze(GENO), **kw)
    jfeats = [jnp.asarray(f) for f in feats]
    variables = _randomized(jnet.init(jax.random.PRNGKey(1), jfeats, False))
    want = np.asarray(jnet.apply(variables, jfeats, False))
    tnet = FoundFusionNetwork.from_genotype(GENO, **kw)
    tnet.load_state_dict(state_dict_from_jax(
        variables["params"], variables.get("batch_stats", {})))
    with torch.no_grad():
        got = tnet.eval()([torch.from_numpy(f) for f in feats])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("average", ["weighted", "macro", "samples"])
def test_metrics_match(average):
    """Per-class counts (with a row mask and an all-negative class) and the
    F1 the serve CLI reports, against the JAX package's metrics."""
    from bmnas_tpu.utils import metrics as jm
    from bmnas_tpu_torch.utils import metrics as tm
    rng = np.random.RandomState(6)
    preds = (rng.rand(12, 23) < 0.3).astype(np.float32)
    labels = (rng.rand(12, 23) < 0.2).astype(np.float32)
    labels[:, 5] = preds[:, 5] = 0.0
    mask = np.ones((12,), np.float32)
    mask[9:] = 0.0
    want = jm.multilabel_counts(jnp.asarray(preds), jnp.asarray(labels),
                                jnp.asarray(mask))
    got = tm.multilabel_counts(torch.from_numpy(preds),
                               torch.from_numpy(labels),
                               torch.from_numpy(mask))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, err_msg=k)
    # samples F1 divides a float32 sum taken in another order: 1e-6
    assert tm.f1_from_counts(got, average) == pytest.approx(
        jm.f1_from_counts({k: np.asarray(v) for k, v in want.items()},
                          average), abs=1e-6)


def test_synthetic_data_identical(tmp_path):
    jmake(str(tmp_path / "j"), n_per_stage=2, image_hw=(8, 8), seed=3)
    tmake(str(tmp_path / "t"), n_per_stage=2, image_hw=(8, 8), seed=3)
    for stage in ("train", "dev", "test"):
        for f in os.listdir(tmp_path / "j" / stage):
            np.testing.assert_array_equal(
                np.load(tmp_path / "j" / stage / f),
                np.load(tmp_path / "t" / stage / f))


def test_serve_cli_matches_jax_cli(nets, tmp_path, capsys):
    """The port's CLI (--device cpu) prints the weighted F1 that JAX's
    main_serve prints for the same weights on the same data."""
    from bmnas_tpu.cli.serve import main_serve as jserve
    from bmnas_tpu_torch.cli.serve import main_serve as tserve
    _, variables, _, sd = nets
    data = str(tmp_path / "data")
    tmake(data, n_per_stage=10, image_hw=(32, 32), seed=5)
    for side in ("jax", "port"):
        best = tmp_path / side / "best"
        best.mkdir(parents=True)
        save_genotype(GENO, str(best / "best_genotype.pkl"))
    jsave(str(tmp_path / "jax" / "best" / "best_model.pt"),
          variables["params"], variables["batch_stats"])
    save_model(str(tmp_path / "port" / "best" / "best_model.pt"), sd)
    flags = ["--datadir", data, "--small_dataset", "--batchsize", "4",
             "--C", "8", "--L", "4", "--num_workers", "2",
             "--fused_kernels"]
    want = jserve(["--task", "mmimdb", "--eval_exp_dir",
                   str(tmp_path / "jax"), *flags])
    capsys.readouterr()
    got = tserve(["--task", "mmimdb", "--eval_exp_dir",
                  str(tmp_path / "port"), "--device", "cpu", *flags])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert got["metric"] == want["metric"] == "weighted_f1"
    assert got["samples"] == want["samples"] == 10
    assert got["batches"] == 3  # the last one ragged and mask-padded
    assert got["samples_per_sec"] > 0
    assert got["value"] == pytest.approx(want["value"], abs=1e-6)


def test_serve_cli_later_tasks_not_ported(tmp_path):
    """Every task is served (NTU: tests/test_torch_port_ntu_serve.py, Ego:
    tests/test_torch_port_ego_serve.py); what is still to come is refused
    with its ROADMAP item for Ego too: an exported program, and the
    decode cache of the Ego search."""
    from bmnas_tpu_torch.cli.serve import main_serve
    base = ["--task", "ego", "--eval_exp_dir", str(tmp_path), "--device",
            "cpu", "--datadir", str(tmp_path)]
    with pytest.raises(SystemExit, match="--export: not ported yet "
                                         r"\(ROADMAP.md Queue 1 item 10"):
        main_serve(base + ["--export", str(tmp_path / "art")])
    with pytest.raises(SystemExit, match="--host_decode_cache_gb: not ported "
                                         r"yet \(ROADMAP.md Queue 1 item 5b"):
        main_serve(base + ["--host_decode_cache_gb", "4"])
    assert os.listdir(tmp_path) == []
