"""Batch-inference serving CLI on top of ``bmnas_tpu_torch.serving``.

Port of ``bmnas_tpu/cli/serve.py::main_serve``. It loads a found
experiment's genotype and model snapshot and serves a dataset split through
``FoundNetServer`` on one device; the task's own flags are its found CLI's
(``cli/mmimdb.py``, ``cli/ntu.py``, ``cli/ego.py::parse_found_args``):

    python -m bmnas_tpu_torch.cli.serve --task mmimdb|ntu|ego \\
        --eval_exp_dir <exp> --datadir <root> [--bf16] [--fused_kernels] \\
        [--split test] [--device cpu]

Ego reads its annotation JSON from ``--checkpointdir`` (``--annotation``)
and maps the split names test/dev/train to the subsets
testing/validation/training. The weights are the snapshot's: serving reads
no backbone checkpoint (``--rgb_cp``, ``--depth_cp``), as in the JAX
package.

It runs on CUDA unless ``--device cpu`` is given, and raises when there is
no CUDA device. Prints one JSON line: {"metric", "value", "samples",
"samples_per_sec", ...}; the metric is the weighted F1 for MM-IMDB and the
accuracy (argmax) for NTU and Ego.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _resolve_artifacts(exp_dir: str, model_path: str = None):
    """(genotype, snapshot) under <exp>/best/: eval dirs carry best_test_*,
    search dirs best_*."""
    best = os.path.join(exp_dir, "best")
    geno = None
    for name in ("best_test_genotype.pkl", "best_genotype.pkl"):
        p = os.path.join(best, name)
        if os.path.exists(p):
            geno = p
            break
    snap = model_path
    if snap is None:
        for name in ("best_test_model.pt", "best_model.pt"):
            p = os.path.join(best, name)
            if os.path.exists(p):
                snap = p
                break
    if geno is None or snap is None:
        raise SystemExit(f"no genotype/model snapshot under {best}")
    return geno, snap


def _parse_task_args(task: str, rest):
    if task == "mmimdb":
        from bmnas_tpu_torch.cli.mmimdb import parse_found_args
        return parse_found_args(rest)
    if task == "ntu":
        from bmnas_tpu_torch.cli.ntu import parse_found_args
        return parse_found_args(rest)
    from bmnas_tpu_torch.cli.ego import parse_found_args
    return parse_found_args(rest)


def _build_task(task: str, args, genotype, device):
    """The task's found net (as each found CLI builds it)."""
    from bmnas_tpu_torch.cli.common import model_kwargs_from_args
    kwargs = dict(node_variant=args.node_variant,
                  fused_eval=args.fused_kernels, device=device,
                  **model_kwargs_from_args(args))
    if task == "mmimdb":
        from bmnas_tpu_torch.models.mmimdb import FoundImageTextNet
        return FoundImageTextNet.from_genotype(genotype, **kwargs)
    if task == "ntu":
        from bmnas_tpu_torch.models.ntu import FoundSkeletonImageNet
        return FoundSkeletonImageNet.from_genotype(genotype, **kwargs)
    from bmnas_tpu_torch.models.ego import FoundRGBDepthNet
    return FoundRGBDepthNet.from_genotype(genotype, **kwargs)


def _dataset(task: str, args, split: str):
    if task == "mmimdb":
        from bmnas_tpu_torch.data.mmimdb import MMIMDBDataset
        return MMIMDBDataset(args.datadir, split,
                             small_dataset=args.small_dataset,
                             num_workers=args.num_workers)
    if task == "ntu":
        from bmnas_tpu_torch.data.ntu import NTUDataset
        return NTUDataset(args.datadir, split,
                          small_dataset=args.small_dataset,
                          vid_len=tuple(args.vid_len), vid_dim=args.vid_dim,
                          num_workers=args.num_workers)
    from bmnas_tpu_torch.data.ego import EgoDataset
    annotation = os.path.join(args.checkpointdir, args.annotation)
    subset = {"test": "testing", "dev": "validation",
              "train": "training"}.get(split, split)
    return EgoDataset(args.datadir, annotation, subset,
                      small_dataset=args.small_dataset,
                      sample_size=args.sample_size,
                      sample_duration=args.sample_duration,
                      downsample=args.downsample,
                      num_workers=args.num_workers)


def _metric(task: str, logits: np.ndarray, labels: np.ndarray):
    if task == "mmimdb":
        from bmnas_tpu_torch.cli.mmimdb import TH_FSCORE
        from bmnas_tpu_torch.utils.metrics import (
            f1_from_counts,
            multilabel_counts,
        )
        preds = torch.from_numpy(1.0 / (1.0 + np.exp(-logits)) > TH_FSCORE)
        counts = multilabel_counts(preds, torch.from_numpy(labels))
        return "weighted_f1", f1_from_counts(counts, "weighted")
    acc = float((logits.argmax(-1) == labels.astype(np.int64)).mean())
    return "accuracy", acc


def main_serve(argv=None):
    top = argparse.ArgumentParser(description="BM-NAS found-net serving "
                                              "(PyTorch port)")
    top.add_argument("--task", choices=["mmimdb", "ntu", "ego"],
                     required=True)
    top.add_argument("--eval_exp_dir", default=None,
                     help="experiment dir with best/{*genotype.pkl,*model.pt}"
                          " (required)")
    top.add_argument("--model", default=None,
                     help="explicit snapshot path (default: best/ lookup)")
    top.add_argument("--split", default="test",
                     help="dataset split/stage to serve")
    top.add_argument("--bf16", action="store_true",
                     help="serve with bfloat16 weights/activations")
    top.add_argument("--device", default=None,
                     help="torch device (default: the current CUDA device; "
                          "'cpu' must be asked for)")
    top.add_argument("--export", default=None, metavar="PATH",
                     help="(not ported yet) write an exported program "
                          "instead of serving")
    top.add_argument("--from_export", default=None, metavar="PATH",
                     help="(not ported yet) serve from an exported program")
    args0, rest = top.parse_known_args(argv)
    from bmnas_tpu_torch.cli.common import refuse_not_ported
    refuse_not_ported(args0, ("--export", "--from_export"))
    if args0.eval_exp_dir is None:
        raise SystemExit("--eval_exp_dir is required")

    from bmnas_tpu_torch.device import resolve_device
    device = resolve_device(args0.device)

    from bmnas_tpu_torch.cli.common import fail_fast_checks
    args = _parse_task_args(args0.task, rest)
    if getattr(args, "task_variant", "bmnas") != "bmnas":
        # the JAX serve CLI ignores the flag and builds the found net, into
        # which an ablation net's snapshot does not load
        raise SystemExit("--task_variant: serving builds the found net of "
                         "the genotype, as the JAX serve CLI does; an "
                         "ablation net's snapshot does not load into it")
    fail_fast_checks(args)

    from bmnas_tpu_torch.genotype import load_genotype
    from bmnas_tpu_torch.serving import load_server

    geno_path, snap_path = _resolve_artifacts(args0.eval_exp_dir, args0.model)
    model = _build_task(args0.task, args, load_genotype(geno_path), device)
    server = load_server(snap_path, model,
                         dtype=torch.bfloat16 if args0.bf16
                         else torch.float32,
                         fused=args.fused_kernels, device=device)
    dataset = _dataset(args0.task, args, args0.split)

    logits_parts, labels_parts = [], []
    n_total = n_warm = n_batches = 0
    t0 = t_warm = time.perf_counter()
    for batch in dataset.batches(args.batchsize, shuffle=False):
        n = int(batch["mask"].sum())
        logits_parts.append(server.predict(batch))
        labels_parts.append(batch["label"][:n])
        n_total += n
        n_batches += 1
        if n_warm == 0:
            # the first batch builds kernels and warms cuDNN; steady-state
            # throughput starts after it
            n_warm, t_warm = n_total, time.perf_counter()
    elapsed = time.perf_counter() - t0
    steady = time.perf_counter() - t_warm
    logits = np.concatenate(logits_parts, axis=0)
    labels = np.concatenate(labels_parts, axis=0)
    name, value = _metric(args0.task, logits, labels)
    result = {
        "metric": name,
        "value": round(value, 6),
        "samples": n_total,
        "batches": n_batches,
        "samples_per_sec": round(
            (n_total - n_warm) / steady if n_total > n_warm
            else n_total / max(elapsed, 1e-9), 2),
        "wall_seconds_incl_warmup": round(elapsed, 2),
        "logits_finite": bool(np.isfinite(logits).all()),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else str(device)),
        "genotype": geno_path,
        "model": snap_path,
        "bf16": bool(args0.bf16),
        "fused_kernels": bool(args.fused_kernels),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main_serve()
