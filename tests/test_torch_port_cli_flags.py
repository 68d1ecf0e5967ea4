"""JAX flags the port parses but has not ported: ``--h2d_streams``,
``--grain_workers`` (both MM-IMDB CLIs and serve) and serve's ``--export`` /
``--from_export``.

Each parses at its default; another value is refused with the ROADMAP.md
item that ports it, before any experiment dir exists. ``--grain_workers 0``
(in-process, as the JAX package takes it with the threads backend) is
accepted and ignored: a JAX serve command line that carries it runs on the
port, on the CPU at a tiny size.
"""
import os

import pytest
import torch

from bmnas_tpu.cli.mmimdb import parse_found_args as jax_parse_found_args
from bmnas_tpu_torch.cli import mmimdb
from bmnas_tpu_torch.cli.serve import main_serve
from bmnas_tpu_torch.data.synthetic import make_mmimdb_synthetic
from bmnas_tpu_torch.genotype import Genotype, StepGenotype, save_genotype
from bmnas_tpu_torch.models.mmimdb import FoundImageTextNet
from bmnas_tpu_torch.utils.checkpoint import save_model

GENO = Genotype(
    edges=[("skip", 0), ("skip", 4), ("skip", 2), ("skip", 5)],
    concat=[6, 7],
    steps=[StepGenotype([("skip", 0), ("skip", 1)], ["ScaleDotAttn"], [2]),
           StepGenotype([("skip", 1), ("skip", 0)], ["LinearGLU"], [2])],
)
TINY = ["--batchsize", "4", "--C", "8", "--L", "4", "--num_workers", "2"]
ITEM_6 = "Queue 1 item 6, data-path infrastructure"
ITEM_10 = "Queue 1 item 10, torch.export"


def _run(cli, tmp_path, flags):
    """The CLI on an empty data dir, on the CPU; it stops at the first
    missing artifact or refused flag."""
    base = ["--datadir", str(tmp_path), "--device", "cpu"]
    if cli == "search":
        return mmimdb.main_search(base + flags)
    if cli == "found":
        return mmimdb.main_found(base + ["--search_exp_dir", str(tmp_path)]
                                 + flags)
    return main_serve(["--task", "mmimdb", "--eval_exp_dir", str(tmp_path)]
                      + base + flags)


@pytest.mark.parametrize("parse", [mmimdb.parse_search_args,
                                   mmimdb.parse_found_args],
                         ids=["search", "found"])
def test_data_path_flags_have_the_jax_defaults(parse):
    args = parse([])
    assert (args.h2d_streams, args.grain_workers) == (1, 0)


@pytest.mark.parametrize("cli", ["search", "found", "serve"])
def test_defaults_given_explicitly_pass(cli, tmp_path, monkeypatch):
    """At their defaults the flags pass the checks: the run goes on to the
    first missing artifact of the empty dir."""
    monkeypatch.chdir(tmp_path)
    flags = ["--h2d_streams", "1", "--grain_workers", "0"]
    with pytest.raises((SystemExit, FileNotFoundError)) as e:
        _run(cli, tmp_path, flags)
    assert "not ported yet" not in str(e.value)


@pytest.mark.parametrize("cli", ["search", "found", "serve"])
@pytest.mark.parametrize("flags,item", [
    (["--h2d_streams", "2"], ITEM_6), (["--grain_workers", "2"], ITEM_6)],
    ids=["h2d_streams", "grain_workers"])
def test_data_path_flags_refused(cli, flags, item, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit,
                       match=f"{flags[0]}: not ported yet \\(ROADMAP.md "
                             f"{item}\\)"):
        _run(cli, tmp_path, flags)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("flag", ["--export", "--from_export"])
def test_export_flags_refused(flag, tmp_path):
    with pytest.raises(SystemExit,
                       match=f"{flag}: not ported yet \\(ROADMAP.md "
                             f"{ITEM_10}\\)"):
        main_serve(["--task", "mmimdb", flag, str(tmp_path / "art"),
                    "--device", "cpu"])
    assert os.listdir(tmp_path) == []


def test_serve_needs_an_eval_dir():
    with pytest.raises(SystemExit, match="--eval_exp_dir is required"):
        main_serve(["--task", "mmimdb", "--device", "cpu"])


def test_jax_command_line_with_grain_workers_runs(tmp_path):
    """A serve command line of the JAX package, ``--grain_workers 0`` and
    ``--h2d_streams 1`` included, serves on the port."""
    data, exp = str(tmp_path / "data"), tmp_path / "exp"
    make_mmimdb_synthetic(data, n_per_stage=5, image_hw=(32, 32), seed=3)
    (exp / "best").mkdir(parents=True)
    save_genotype(GENO, str(exp / "best" / "best_genotype.pkl"))
    torch.manual_seed(0)
    net = FoundImageTextNet.from_genotype(
        GENO, C=8, L=4, steps=2, multiplier=2, node_steps=1,
        node_multiplier=1, num_input_nodes=6, num_keep_edges=2,
        num_outputs=23, drpt=0.1, device="cpu")
    save_model(str(exp / "best" / "best_model.pt"), net)
    rest = ["--datadir", data, *TINY, "--grain_workers", "0",
            "--h2d_streams", "1"]
    jargs = jax_parse_found_args(rest)  # the JAX package takes the line
    assert (jargs.grain_workers, jargs.h2d_streams) == (0, 1)
    got = main_serve(["--task", "mmimdb", "--eval_exp_dir", str(exp),
                      "--device", "cpu", *rest])
    assert got["samples"] == 5 and got["batches"] == 2
    assert got["logits_finite"]
