"""Epoch loop of the bilevel search and of found retraining.

Port of the streaming path of ``bmnas_tpu/search/loop.py::run_training``:

* ``status='search'``: phases train -> dev every epoch: a weight step on
  every train batch (the scheduler steps once per batch), an arch step on
  every dev batch. Best-dev tracking: ``<exp>/best/best_model.pt``
  (state_dict plus the arch tensors) and ``<exp>/best/best_genotype.pkl``.
* ``status='eval'`` (found retraining): phases train -> dev -> test for
  MM-IMDB, train -> test for the video tasks. MM-IMDB's dev phase trains
  weights too (the reference's found loop), so the scheduler steps on dev
  batches as well; test runs the eval step. Best-test tracking:
  ``best/best_test_model.pt`` and ``best/best_test_genotype.pkl``.
* best tracking: MM-IMDB keeps a new best when it is strictly better, the
  video tasks also on a tie (``>=``), as the reference's loops do;
* ``metric='f1'`` (MM-IMDB, from the multilabel counts) or ``'acc'``
  (``correct / dataset_size``);
* the NaN-loss escape and the NaN-metric one-extra-epoch failsafe;
* the genotype plot of every epoch at ``<exp>/architectures/epoch_N``;
* the full-resume checkpoint ``<exp>/checkpoint.pt`` after every epoch
  (``utils/checkpoint.save_state``), and ``resume_info`` from
  ``cli/common.apply_resume`` to continue after the checkpointed epoch;
* the reference's log lines ('{phase} Loss: ..., {f1} F1: ...' or
  '{phase} Loss: ... Acc: ...', 'Fusion Model Params: N', 'Current best
  dev/test ...') and a ``metrics.jsonl`` row per phase.

Metric counts stay on the device and cross to the host once a phase. The
JAX loop's device-cache, frame-pool, ``--unrolled`` and
``--steps_per_dispatch`` branches and its profiler are later slices
(ROADMAP.md Queue 1).
"""
from __future__ import annotations

import copy
import json
import math
import os
from typing import Callable, Dict, Optional

import numpy as np

from bmnas_tpu_torch.genotype import Genotype, save_genotype
from bmnas_tpu_torch.search.bilevel import StepFunctions, TrainState
from bmnas_tpu_torch.utils import checkpoint as ckpt
from bmnas_tpu_torch.utils.metrics import count_parameters, f1_from_counts


def _accumulate(total, counts):
    if total is None:
        return counts
    return {k: total[k] + counts[k] for k in total}


def _finalize_metric(counts: Dict, metric: str, f1_type: str,
                     dataset_size: int):
    host = {k: np.asarray(v.detach().cpu()) for k, v in counts.items()}
    loss = float(host["loss_sum"]) / dataset_size
    if metric == "f1":
        return loss, f1_from_counts(host, average=f1_type, zero_division=1.0)
    return loss, float(host["correct"]) / dataset_size


def _fusion_part(name: str) -> bool:
    """Top-level submodules counted as 'Fusion Model Params'."""
    return name.startswith("reshape_") or name == "fusion_net"


def run_training(
    *,
    task: str,
    status: str,                       # 'search' | 'eval'
    fns: StepFunctions,
    state: TrainState,
    scheduler,
    loaders: Dict[str, Callable],      # phase -> fn(epoch) -> batch iterator
    dataset_sizes: Dict[str, int],
    num_epochs: int,
    f1_type: str,
    metric: str = "f1",                # 'f1' | 'acc'
    args,
    logger,
    plotter,
    genotype_fn: Callable[[TrainState], Genotype],
    resume_info: Optional[Dict] = None,  # from cli.common.apply_resume
):
    """Returns (best_metric, best_genotype, state): the best dev metric in
    search mode, the best test metric and its genotype in eval mode."""
    best_metric, best_genotype, best_epoch = 0.0, None, 0
    best_test_metric, best_test_genotype, best_test_epoch = 0.0, None, 0
    start_epoch = 0
    if resume_info:
        start_epoch = resume_info["start_epoch"]
        best_metric = resume_info["best_metric"]
        best_test_metric = resume_info["best_test_metric"]
        best_epoch = resume_info["best_epoch"]
        best_test_epoch = resume_info["best_test_epoch"]
        best_genotype = resume_info["best_genotype"]
        best_test_genotype = resume_info["best_test_genotype"]
    if status == "search":
        phases = ("train", "dev")
    elif task == "mmimdb":
        phases = ("train", "dev", "test")
    else:
        phases = ("train", "test")

    def better(value, best_so_far):
        return (value > best_so_far if task == "mmimdb"
                else value >= best_so_far)
    best = os.path.join(args.save, "best")

    failsafe = True
    cont_overloop = 0
    while failsafe:
        for epoch in range(start_epoch, num_epochs):
            logger.info("Epoch: {}".format(epoch))
            logger.info("EXP: {}".format(args.save))
            for phase in phases:
                trains_weights = phase == "train" or (
                    phase == "dev" and status == "eval")
                arch_steps = status == "search" and phase == "dev"
                counts_total = None
                for batch in loaders[phase](epoch):
                    if arch_steps:
                        counts = fns.arch_step(state, batch)
                    elif trains_weights:
                        counts = fns.weight_step(state, batch,
                                                 scheduler.step())
                    else:
                        counts = fns.eval_step(state, batch)
                    counts_total = _accumulate(counts_total, counts)
                epoch_loss, epoch_metric = _finalize_metric(
                    counts_total, metric, f1_type, dataset_sizes[phase])
                # chip_smoke.py's PhaseLaunches keys on '<phase> Loss:'.
                if metric == "f1":
                    logger.info("{} Loss: {:.4f}, {} F1: {:.4f}".format(
                        phase, epoch_loss, f1_type, epoch_metric))
                else:
                    logger.info("{} Loss: {:.4f} Acc: {:.4f}".format(
                        phase, epoch_loss, epoch_metric))
                with open(os.path.join(args.save, "metrics.jsonl"),
                          "a") as mf:
                    mf.write(json.dumps({
                        "epoch": epoch, "phase": phase, "loss": epoch_loss,
                        "metric": epoch_metric,
                        "metric_name": ("%s_f1" % f1_type if metric == "f1"
                                        else "acc")}) + "\n")

                num_params = sum(
                    count_parameters(m)
                    for k, m in state.model.named_children()
                    if _fusion_part(k))
                logger.info("Fusion Model Params: {}".format(num_params))

                genotype = genotype_fn(state)
                if genotype is not None:  # the NTU ablation nets have none
                    logger.info(str(genotype))

                if phase == "train" and math.isnan(epoch_loss):
                    logger.info("Nan loss during training, escaping")
                    return best_metric, best_genotype, state

                if arch_steps and better(epoch_metric, best_metric):
                    best_metric = epoch_metric
                    best_genotype = copy.deepcopy(genotype)
                    best_epoch = epoch
                    ckpt.save_model(os.path.join(best, "best_model.pt"),
                                    state.model, state.arch)
                    if best_genotype is not None:
                        save_genotype(best_genotype, os.path.join(
                            best, "best_genotype.pkl"))

                if phase == "test" and better(epoch_metric,
                                              best_test_metric):
                    best_test_metric = epoch_metric
                    best_test_genotype = copy.deepcopy(genotype)
                    best_test_epoch = epoch
                    ckpt.save_model(os.path.join(best, "best_test_model.pt"),
                                    state.model, state.arch)
                    if best_test_genotype is not None:
                        save_genotype(best_test_genotype, os.path.join(
                            best, "best_test_genotype.pkl"))

            if genotype is not None:
                plotter.plot(genotype,
                             os.path.join(args.save, "architectures",
                                          "epoch_{}".format(epoch)),
                             task=task)

            if metric == "f1":
                logger.info("Current best dev {} F1: {}, at training epoch: "
                            "{}".format(f1_type, best_metric, best_epoch))
                logger.info("Current best test {} F1: {}, at training epoch: "
                            "{}".format(f1_type, best_test_metric,
                                        best_test_epoch))
            else:
                logger.info("Current best dev accuracy: {}, at training "
                            "epoch: {}".format(best_metric, best_epoch))
                logger.info("Current best test accuracy: {}, at training "
                            "epoch: {}".format(best_test_metric,
                                               best_test_epoch))

            ckpt.save_state(
                os.path.join(args.save, "checkpoint.pt"), state,
                extra={"epoch": epoch, "scheduler": scheduler.state(),
                       "best_metric": best_metric,
                       "best_test_metric": best_test_metric,
                       "best_epoch": best_epoch,
                       "best_test_epoch": best_test_epoch})

        # NaN-metric failsafe: train one more epoch
        if math.isnan(best_metric) and num_epochs == 1 and cont_overloop < 1:
            failsafe = True
            logger.info("Recording a NaN F1, training for one more epoch.")
        else:
            failsafe = False
        cont_overloop += 1

    if math.isnan(best_metric):
        best_metric = 0.0
    if status == "search":
        return best_metric, best_genotype, state
    return best_test_metric, best_test_genotype, state
