"""The port's Ego data path, server and serve CLI against the JAX package.

Synthetic EgoGesture splits written by both packages'
``make_ego_synthetic`` from one seed must be the same bytes; the port's
``_load_jpg`` must decode colour, gray and colour-encoded gray JPEGs as the
JAX one does, by the same route; its ``EgoDataset`` must yield the JAX
batches (mask and ragged last batch included); a JAX ``FoundRGBDepthNet``
(C=8, L=4, two cells of three chained inner steps, node multiplier 3, two
full ResNeXt-101s) carried into the port must give the same logits through
the server (1e-4) and the same accuracy through the serve CLI (1e-6). fp32
on the CPU, 4-frame clips of 32x32, every file under ``tmp_path``.
"""
import filecmp
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmnas_tpu.data import ego as jdata
from bmnas_tpu.data.synthetic import make_ego_synthetic as jmake
from bmnas_tpu.genotype import Genotype, StepGenotype, save_genotype
from bmnas_tpu.models.ego import FoundRGBDepthNet as JNet
from bmnas_tpu.utils.checkpoint import save_model as jsave
from bmnas_tpu_torch.cli.ego import parse_found_args
from bmnas_tpu_torch.data import ego as tdata
from bmnas_tpu_torch.data.synthetic import make_ego_synthetic as tmake
from bmnas_tpu_torch.models.ego import FoundRGBDepthNet as TNet
from bmnas_tpu_torch.ops.kernels import LAUNCHES, reset_launches
from bmnas_tpu_torch.serving import FoundNetServer
from bmnas_tpu_torch.utils.checkpoint import save_model
from bmnas_tpu_torch.utils.convert import state_dict_from_jax

GENO = Genotype(
    edges=[("skip", 0), ("skip", 4), ("skip", 7), ("skip", 8)],
    concat=[8, 9],
    steps=[StepGenotype([("skip", 0), ("skip", 1), ("skip", 1), ("skip", 2),
                         ("skip", 2), ("skip", 3)],
                        ["ScaleDotAttn", "LinearGLU", "ConcatFC"],
                        [2, 3, 4]),
           StepGenotype([("skip", 1), ("skip", 0), ("skip", 2), ("skip", 1),
                         ("skip", 3), ("skip", 0)],
                        ["Sum", "ConcatFC", "LinearGLU"], [2, 3, 4])],
)
CFG = dict(C=8, L=4, steps=2, multiplier=2, node_steps=3, node_multiplier=3,
           num_input_nodes=8, num_keep_edges=2, num_outputs=5, drpt=0.0)
# 6 test gestures (a full batch of 4 and a ragged one of 2) of 6 frames,
# packed into one video of 9 frames, where their segments overlap; 40x30
# frames (landscape: the short side scales to 32, the long one to
# round(42.67) = 43); smooth frames, as the chip smoke test writes them
SYNTH = dict(counts={"training": 1, "validation": 2, "testing": 6},
             num_classes=5, frames=6, gestures_per_video=6, frame_wh=(40, 30),
             smooth=True, seed=3)
FLAGS = ["--batchsize", "4", "--C", "8", "--L", "4", "--num_outputs", "5",
         "--sample_size", "32", "--sample_duration", "4", "--num_workers",
         "2", "--fused_kernels"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ego")
    jmake(str(root / "jax"), **SYNTH)
    tmake(str(root / "port"), **SYNTH)
    return root


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_synthetic_files_identical(data, tmp_path):
    """The JPEGs and the annotation, with the chip's options (counts,
    packed gestures, 40x30 smooth frames) and with the defaults (noise)."""
    names = _files(data / "jax")
    assert names == _files(data / "port")
    # a video a subset, of 6, 6 and 9 frames
    assert len(names) == 1 + 2 * (6 + 6 + 9)
    _, mismatch, errors = filecmp.cmpfiles(data / "jax", data / "port",
                                           names, shallow=False)
    assert not mismatch and not errors
    ann = json.loads((data / "port" / "annotation.json").read_text())
    assert sum(v["subset"] == "testing"
               for v in ann["database"].values()) == 6
    jmake(str(tmp_path / "jax"))
    tmake(str(tmp_path / "port"))
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port") and len(names) == 1 + 2 * 12 * 12
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax",
                                           tmp_path / "port", names,
                                           shallow=False)
    assert not mismatch and not errors


def _jpegs(tmp_path):
    """A colour, a gray and a colour-encoded gray JPEG."""
    from PIL import Image
    rng = np.random.RandomState(7)
    paths = {}
    for name, arr in (("colour", rng.randint(0, 256, (12, 10, 3))),
                      ("gray", rng.randint(0, 256, (12, 10))),
                      ("colour_gray", rng.randint(0, 256, (12, 10, 3)))):
        paths[name] = str(tmp_path / f"{name}.jpg")
        Image.fromarray(arr.astype(np.uint8)).save(paths[name])
    return paths


def _spy_decoders(monkeypatch):
    """The list that ``cv2.imread`` and PIL's ``Image.open`` append their
    names to when called."""
    import cv2
    from PIL import Image
    called = []
    for mod, name, tag in ((cv2, "imread", "cv2"), (Image, "open", "PIL")):
        def spy(*a, _orig=getattr(mod, name), _tag=tag, **k):
            called.append(_tag)
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    return called


def _decodes(paths, called):
    """(port, JAX, the decoders the port called) for the three frames."""
    out = []
    for p, gray in ((paths["colour"], False), (paths["gray"], True),
                    (paths["colour_gray"], True)):
        called.clear()
        got = tdata._load_jpg(p, gray)
        route = tuple(called)
        out.append((got, jdata._load_jpg(p, gray), route))
    return out


def test_load_jpg_matches_by_route(tmp_path, monkeypatch):
    """OpenCV for colour (orientation ignored) and gray; a colour-encoded
    gray frame through PIL's convert('L'); PIL alone where OpenCV is not
    installed; and an error, never other bytes, with neither."""
    paths = _jpegs(tmp_path)
    called = _spy_decoders(monkeypatch)
    decoded = _decodes(paths, called)
    for got, want, _ in decoded:
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert [r for _, _, r in decoded] == [("cv2",), ("cv2",), ("cv2", "PIL")]
    monkeypatch.setattr(tdata, "_cv2", lambda: None)
    monkeypatch.setattr(jdata, "cv2", None)
    decoded = _decodes(paths, called)
    for got, want, _ in decoded:
        np.testing.assert_array_equal(got, want)
    assert [g.shape for g, _, _ in decoded] == [(12, 10, 3), (12, 10, 1),
                                                (12, 10, 1)]
    assert [r for _, _, r in decoded] == [("PIL",)] * 3
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match="neither OpenCV"):
        tdata._load_jpg(paths["colour"], False)
    with pytest.raises(RuntimeError, match="OpenCV"):
        tdata._resize(np.zeros((4, 4, 3), np.uint8), (2, 2))


def test_transforms_match():
    """The temporal centre crop (looped where the clip is short,
    downsampled) and the scale + centre crop of portrait, landscape and
    one-channel frames (OpenCV drops the channel axis of a one-channel
    resize; it comes back)."""
    for n, size, ds in ((40, 32, 1), (10, 8, 2), (3, 8, 1), (33, 16, 2)):
        idx = list(range(5, 5 + n))
        assert (tdata.temporal_center_crop(idx, size, ds)
                == jdata.temporal_center_crop(idx, size, ds))
    rng = np.random.RandomState(8)
    for shape in ((30, 40, 3), (41, 29, 3), (30, 40, 1), (240, 320, 1)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        got = tdata.scale_center_crop(img, 32)
        want = jdata.scale_center_crop(img, 32)
        assert got.shape == want.shape == (32, 32, shape[2])
        np.testing.assert_array_equal(got, want)


def test_dataset_batches_match(data):
    kw = dict(sample_size=32, sample_duration=4, num_workers=2)
    ann = str(data / "port" / "annotation.json")
    root = str(data / "port")
    want = list(jdata.EgoDataset(root, ann, "testing", **kw)
                .batches(4, shuffle=False))
    ds = tdata.EgoDataset(root, ann, "testing", **kw)
    got = list(ds.batches(4, shuffle=False))
    assert len(ds) == 6 and ds.num_batches(4) == len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"rgb", "depth", "label", "mask"}
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[0]["rgb"].shape == (4, 4, 32, 32, 3)
    assert got[0]["depth"].shape == (4, 4, 32, 32, 1)
    assert got[0]["rgb"].dtype == got[0]["depth"].dtype == np.uint8
    assert got[1]["mask"].tolist() == [1.0, 1.0, 0.0, 0.0]
    assert not got[1]["rgb"][2:].any()
    for subset, n in (("train_dev", 3), ("validation", 2)):
        g = tdata.EgoDataset(root, ann, subset, **kw)
        w = jdata.EgoDataset(root, ann, subset, **kw)
        assert [r["video"] for r in g.data] == [r["video"] for r in w.data]
        assert len(g) == n
    small = tdata.EgoDataset(root, ann, "testing", small_dataset=True, **kw)
    assert len(small) == 6
    with pytest.raises(NotImplementedError, match="Queue 1 item 5b"):
        tdata.EgoDataset(root, ann, "training", train_transform=True, **kw)


def test_found_args_have_the_jax_defaults():
    """The flags serving reads parse on the port with the JAX Ego found
    CLI's defaults."""
    from bmnas_tpu.cli.ego import parse_found_args as jparse
    want, got = vars(jparse([])), vars(parse_found_args([]))
    served = ("C", "L", "steps", "multiplier", "node_steps",
              "node_multiplier", "num_input_nodes", "num_keep_edges",
              "num_outputs", "drpt", "batchsize", "datadir", "checkpointdir",
              "annotation", "rgb_cp", "depth_cp", "small_dataset",
              "num_workers", "sample_size", "sample_duration", "downsample",
              "node_variant", "fused_kernels", "host_decode_cache_gb",
              "device_cache_budget_gb")
    assert {k: got[k] for k in served} == {k: want[k] for k in served}
    assert (got["C"], got["L"], got["steps"], got["node_steps"],
            got["node_multiplier"], got["num_input_nodes"],
            got["num_outputs"], got["batchsize"], got["sample_size"],
            got["sample_duration"]) == (128, 8, 2, 3, 3, 8, 83, 96, 112, 32)
    assert parse_found_args(["--j", "3"]).num_workers == 3


def _checkpointdir(data, tmp_path):
    """The JAX defaults' layout: the annotation JSON beside both backbone
    checkpoints (``--rgb_cp``, ``--depth_cp`` at their default names)."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "annotation.json").write_text(
        (data / "port" / "annotation.json").read_text())
    defaults = parse_found_args([])
    for name in (defaults.rgb_cp, defaults.depth_cp):
        (ckpt / name).write_bytes(b"")
    return ckpt


def test_serve_cli_refuses_backbone_checkpoints(data, tmp_path):
    """Whether serving refuses backbone checkpoints: it does not. It takes
    its weights from the snapshot and reads no backbone checkpoint, as the
    JAX serve CLI, so a ``--checkpointdir`` that holds both beside the
    annotation gives the test split's batches, the split names mapped to
    the annotation's subsets. (Ego's search and found CLIs will refuse
    one, ROADMAP.md Queue 1 item 5b.)"""
    from bmnas_tpu_torch.cli.serve import _dataset, _parse_task_args
    args = _parse_task_args("ego", [
        "--datadir", str(data / "port"), "--checkpointdir",
        str(_checkpointdir(data, tmp_path)), "--annotation",
        "annotation.json", *FLAGS])
    want = tdata.EgoDataset(str(data / "port"),
                            str(data / "port" / "annotation.json"),
                            "testing", sample_size=32, sample_duration=4)
    got = _dataset("ego", args, "test")
    assert len(got) == len(want) == 6
    for g, w in zip(got.batches(4, False), want.batches(4, False)):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


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
    b = {"rgb": rng.randint(0, 256, (n, 4, 32, 32, 3)).astype(np.uint8),
         "depth": rng.randint(0, 256, (n, 4, 32, 32, 1)).astype(np.uint8),
         "label": rng.randint(0, 5, (n,)).astype(np.int32),
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
        assert got.shape == want.shape == (int(b["mask"].sum()), 5)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert LAUNCHES["found_cell"] == 0  # the CPU never launches the kernel


def test_bf16_server_keeps_batchnorm_in_fp32(nets):
    """A bf16 server casts the net to bf16 but its BatchNorms (the two
    ResNeXt-101s' 2 x 104, the reshapes', the cells'), whose weights and
    statistics stay the snapshot's fp32 values; its logits come back in
    fp32 and finite."""
    _, _, sd = nets
    server = FoundNetServer(TNet.from_genotype(GENO, **CFG), sd,
                            dtype=torch.bfloat16, fused=True, device="cpu")
    bns = {n for n, m in server.model.named_modules()
           if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}
    assert len({n for n in bns if n.startswith(("rgb_net.",
                                                "depth_net."))}) == 2 * 104
    for key, value in server.model.state_dict().items():
        if key.rpartition(".")[0] in bns:
            assert value.dtype == sd[key].dtype
            torch.testing.assert_close(value, sd[key], rtol=0, atol=0)
        elif value.is_floating_point():
            assert value.dtype == torch.bfloat16, key
    out = server.predict(_batch(4, valid=3))
    assert out.dtype == np.float32 and out.shape == (3, 5)
    assert np.isfinite(out).all()


def test_serve_cli_ego_matches_jax_cli(nets, data, tmp_path, capsys):
    """``main_serve --task ego --device cpu`` prints the accuracy that the
    JAX package's serve CLI prints for the same weights on the same data,
    the annotation read from a ``--checkpointdir`` that also holds the
    backbone checkpoints."""
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
    paths = ["--datadir", str(data / "port"), "--checkpointdir",
             str(_checkpointdir(data, tmp_path)), "--annotation",
             "annotation.json"]
    want = jserve(["--task", "ego", "--eval_exp_dir", str(tmp_path / "jax"),
                   *paths, *FLAGS])
    capsys.readouterr()
    got = tserve(["--task", "ego", "--eval_exp_dir", str(tmp_path / "port"),
                  "--device", "cpu", *paths, *FLAGS])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert got["metric"] == want["metric"] == "accuracy"
    assert got["samples"] == want["samples"] == 6
    assert got["batches"] == 2  # the last one ragged and mask-padded
    assert got["logits_finite"]
    assert got["value"] == pytest.approx(want["value"], abs=1e-6)
