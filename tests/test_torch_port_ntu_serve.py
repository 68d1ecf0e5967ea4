"""The port's NTU data path, server and serve CLI against the JAX package.

Synthetic NTU splits written by both packages' ``make_ntu_synthetic`` from
one seed must be the same bytes; the port's ``NTUDataset`` must yield the
JAX batches (mask and ragged last batch included); a JAX
``FoundSkeletonImageNet`` (C=8, L=4, two chained inner steps, node
multiplier 2) carried into the port must give the same logits through the
server (1e-4) and the same accuracy through the serve CLI (1e-6). fp32 on
the CPU, every file under ``tmp_path``.
"""
import filecmp
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmnas_tpu.data import ntu as jdata
from bmnas_tpu.data.synthetic import make_ntu_synthetic as jmake
from bmnas_tpu.genotype import Genotype, StepGenotype, save_genotype
from bmnas_tpu.models.ntu import FoundSkeletonImageNet as JNet
from bmnas_tpu.utils.checkpoint import save_model as jsave
from bmnas_tpu_torch.cli.ntu import parse_found_args
from bmnas_tpu_torch.data import ntu as tdata
from bmnas_tpu_torch.data.synthetic import make_ntu_synthetic as tmake
from bmnas_tpu_torch.models.ntu import FoundSkeletonImageNet as TNet
from bmnas_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from bmnas_tpu_torch.serving import FoundNetServer
from bmnas_tpu_torch.utils.checkpoint import save_model
from bmnas_tpu_torch.utils.convert import state_dict_from_jax

GENO = Genotype(
    edges=[("skip", 0), ("skip", 7), ("skip", 8), ("skip", 4)],
    concat=[8, 9],
    steps=[StepGenotype([("skip", 0), ("skip", 1), ("skip", 2), ("skip", 1)],
                        ["ScaleDotAttn", "LinearGLU"], [2, 3]),
           StepGenotype([("skip", 1), ("skip", 0), ("skip", 2), ("skip", 0)],
                        ["ConcatFC", "Sum"], [2, 3])],
)
CFG = dict(C=8, L=4, steps=2, multiplier=2, node_steps=2, node_multiplier=2,
           num_input_nodes=8, num_keep_edges=2, num_outputs=6, drpt=0.0)
# 3 clips for each of the test subjects 3 and 6: one full batch of 4 and a
# ragged one of 2
SYNTH = dict(n_videos_per_subject=3, hw=32, frames=9, ske_frames=40, seed=4)
FLAGS = ["--batchsize", "4", "--C", "8", "--L", "4", "--num_outputs", "6",
         "--vid_len", "2", "32", "--num_workers", "2", "--fused_kernels"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ntu")
    jmake(str(root / "jax"), **SYNTH)
    tmake(str(root / "port"), **SYNTH)
    return root


def test_synthetic_files_identical(data):
    for sub in ("nturgb+d_rgb_256x256_30", "nturgb+d_skeletons"):
        names = sorted(os.listdir(data / "jax" / sub))
        assert names == sorted(os.listdir(data / "port" / sub))
        assert len(names) == 18
        _, mismatch, errors = filecmp.cmpfiles(
            data / "jax" / sub, data / "port" / sub, names, shallow=False)
        assert not mismatch and not errors


def test_sample_transforms_match(data):
    """The skeleton parser, the centring, the temporal resample and the
    centre crop, against the JAX package's, on one synthetic sample."""
    name = sorted(os.listdir(data / "port" / "nturgb+d_skeletons"))[0]
    ske = tdata.get_3d_skeleton(str(data / "port" / "nturgb+d_skeletons"
                                    / name))
    np.testing.assert_array_equal(ske, jdata.get_3d_skeleton(
        str(data / "port" / "nturgb+d_skeletons" / name)))
    assert ske.shape == (3, 40, 25, 2)
    rgb = np.random.RandomState(0).randint(0, 256, (9, 4, 4, 3)).astype(
        np.uint8)
    for fn, args in ((tdata.normalize_sample, (rgb, ske, False)),
                     (tdata.normalize_sample, (rgb, ske, True)),
                     (tdata.center_crop, (rgb, ske)),
                     (tdata.normalize_len, (rgb, ske, (3, 32))),
                     (tdata._linear_interp_T, (ske, 17))):
        got = fn(*args)
        want = getattr(jdata, fn.__name__)(*args)
        for g, w in zip(got, want) if isinstance(got, tuple) else [(got,
                                                                    want)]:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_load_video_avi_matches(tmp_path):
    """An .avi decoded through OpenCV and sampled as the JAX package does,
    short of its sample count (duplicate indices collapse, slots stay
    zero)."""
    import cv2
    path = str(tmp_path / "clip_rgb.avi")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 30,
                             (16, 12))
    rng = np.random.RandomState(1)
    for _ in range(5):
        writer.write(rng.randint(0, 256, (12, 16, 3)).astype(np.uint8))
    writer.release()
    got = tdata.load_video(path, vid_len=8)
    want = jdata.load_video(path, vid_len=8)
    assert got.shape == (8, 12, 16, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got[:5].any() and not got[5:].any()


def test_dataset_batches_match(data):
    kw = dict(vid_len=(2, 32), num_workers=2)
    want = list(jdata.NTUDataset(str(data / "port"), "test", **kw)
                .batches(4, shuffle=False))
    ds = tdata.NTUDataset(str(data / "port"), "test", **kw)
    got = list(ds.batches(4, shuffle=False))
    assert len(ds) == 6 and ds.num_batches(4) == len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "skeleton", "label", "mask"}
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[0]["image"].shape == (4, 2, 32, 32, 3)
    assert got[0]["image"].dtype == np.uint8
    assert got[1]["mask"].tolist() == [1.0, 1.0, 0.0, 0.0]
    shuffled = list(ds.batches(4, shuffle=True, seed=3))
    jshuffled = list(jdata.NTUDataset(str(data / "port"), "test", **kw)
                     .batches(4, shuffle=True, seed=3))
    for g, w in zip(shuffled, jshuffled):
        np.testing.assert_array_equal(g["label"], w["label"])
        np.testing.assert_array_equal(g["skeleton"], w["skeleton"])


def test_found_args_have_the_jax_defaults():
    """The flags serving reads parse on the port with the JAX NTU found
    CLI's defaults."""
    from bmnas_tpu.cli.ntu import parse_found_args as jparse
    want, got = vars(jparse([])), vars(parse_found_args([]))
    served = ("C", "L", "steps", "multiplier", "node_steps",
              "node_multiplier", "num_input_nodes", "num_keep_edges",
              "num_outputs", "drpt", "batchsize", "datadir", "small_dataset",
              "num_workers", "vid_len", "vid_dim", "node_variant",
              "fused_kernels", "task_variant")
    assert {k: got[k] for k in served} == {k: want[k] for k in served}
    assert (got["C"], got["L"], got["steps"], got["node_steps"],
            got["node_multiplier"], got["batchsize"]) == (128, 8, 4, 2, 2, 96)


@pytest.fixture(scope="module")
def nets():
    jnet = JNet.from_genotype(GENO, **CFG)
    b = _batch(2)
    variables = jax.jit(lambda k, b: jnet.init(k, b, None, False))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in b.items()})
    rng = np.random.RandomState(0)

    def shift(path, a):  # BatchNorm statistics, affines and biases
        a = np.asarray(a)
        return a if path[-1].key == "kernel" else a + rng.rand(
            *a.shape).astype(np.float32) * 0.1
    variables = jax.tree_util.tree_map_with_path(
        shift, jax.tree_util.tree_map(np.asarray, dict(variables)))
    sd = state_dict_from_jax(variables["params"], variables["batch_stats"])
    return jnet, variables, sd


def _batch(n, valid=None, seed=1):
    rng = np.random.RandomState(seed)
    b = {"image": rng.randint(0, 256, (n, 2, 32, 32, 3)).astype(np.uint8),
         "skeleton": rng.randn(n, 32, 25, 2, 3).astype(np.float32) * 0.1,
         "label": rng.randint(0, 6, (n,)).astype(np.int32),
         "mask": np.zeros((n,), np.float32)}
    b["mask"][:n if valid is None else valid] = 1.0
    return b


def test_server_matches_jax_fused_server(nets):
    """uint8 clips and the mask go to the model as they are; the padded
    rows are normalized to zero and trimmed from the logits."""
    from bmnas_tpu.serving import FoundNetServer as JServer
    jnet, variables, sd = nets
    jserver = JServer(jnet, variables["params"], variables["batch_stats"],
                      fused=True)
    tserver = FoundNetServer(TNet.from_genotype(GENO, **CFG), sd, fused=True,
                             device="cpu")
    reset_launches()
    for b in (_batch(4), _batch(4, valid=3, seed=2)):
        want = jserver.predict(b)
        got = tserver.predict(b)
        assert got.shape == want.shape == (int(b["mask"].sum()), 6)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert LAUNCHES["found_cell"] == 0  # the CPU never launches the kernel


def test_bf16_server_keeps_batchnorm_in_fp32(nets):
    """A bf16 server casts the net to bf16 but its BatchNorms, whose
    weights and statistics stay the snapshot's fp32 values (eval
    BatchNorm takes bf16 activations with fp32 operands); its logits come
    back in fp32 and finite."""
    _, _, sd = nets
    server = FoundNetServer(TNet.from_genotype(GENO, **CFG), sd,
                            dtype=torch.bfloat16, fused=True, device="cpu")
    bns = {n for n, m in server.model.named_modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
    assert len(bns) > 53  # the 3D ResNet-50's, the reshapes', the cells'
    for key, value in server.model.state_dict().items():
        if key.rpartition(".")[0] in bns:
            assert value.dtype == sd[key].dtype
            torch.testing.assert_close(value, sd[key], rtol=0, atol=0)
        elif value.is_floating_point():
            assert value.dtype == torch.bfloat16, key
    out = server.predict(_batch(4, valid=3))
    assert out.dtype == np.float32 and out.shape == (3, 6)
    assert np.isfinite(out).all()


def test_serve_cli_ntu_matches_jax_cli(nets, data, tmp_path, capsys):
    """``main_serve --task ntu --device cpu`` prints the accuracy that the
    JAX package's serve CLI prints for the same weights on the same data."""
    from bmnas_tpu.cli.serve import main_serve as jserve
    from bmnas_tpu_torch.cli.serve import main_serve as tserve
    _, variables, sd = nets
    for side in ("jax", "port"):
        best = tmp_path / side / "best"
        best.mkdir(parents=True)
        save_genotype(GENO, str(best / "best_genotype.pkl"))
    jsave(str(tmp_path / "jax" / "best" / "best_model.pt"),
          variables["params"], variables["batch_stats"])
    save_model(str(tmp_path / "port" / "best" / "best_model.pt"), sd)
    datadir = ["--datadir", str(data / "port")]
    want = jserve(["--task", "ntu", "--eval_exp_dir", str(tmp_path / "jax"),
                   *datadir, *FLAGS])
    capsys.readouterr()
    got = tserve(["--task", "ntu", "--eval_exp_dir", str(tmp_path / "port"),
                  "--device", "cpu", *datadir, *FLAGS])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert got["metric"] == want["metric"] == "accuracy"
    assert got["samples"] == want["samples"] == 6
    assert got["batches"] == 2  # the last one ragged and mask-padded
    assert got["logits_finite"]
    assert got["value"] == pytest.approx(want["value"], abs=1e-6)


def test_serve_cli_ntu_refuses_task_variant(tmp_path):
    """Serving builds the found net (the JAX serve CLI ignores the flag),
    into which an ablation net's snapshot does not load."""
    from bmnas_tpu_torch.cli.serve import main_serve
    with pytest.raises(SystemExit, match="--task_variant: serving builds "
                                         "the found net"):
        main_serve(["--task", "ntu", "--eval_exp_dir", str(tmp_path),
                    "--device", "cpu", "--task_variant", "ensemble"])


def test_ntu_model_refuses_unhostable_cells():
    """A found cell the kernel cannot host (an inner ``fc_relu`` edge) is
    refused when the net is built for the kernel (here ``fused_eval``; on
    CUDA always), never run some other way."""
    bad = Genotype(edges=GENO.edges, concat=GENO.concat,
                   steps=[StepGenotype([("fc_relu", 0), ("skip", 1),
                                        ("skip", 2), ("skip", 1)],
                                       ["Sum", "Sum"], [2, 3])] * 2)
    with pytest.raises(ValueError, match="cannot host"):
        TNet.from_genotype(bad, fused_eval=True, **CFG)
