"""Bilevel (weights / architecture) search steps.

Port of ``bmnas_tpu/search/bilevel.py`` (weight_step, arch_step, eval_step,
the masked criteria and the two optimizers):

* weight step: a train-mode forward and backward on a train batch, Adam
  over the trainable (non-frozen) parameters at the scheduler's eta;
* arch step (first-order DARTS): a train-mode forward and backward on a dev
  batch, Adam over the arch tensors only, then a second train-mode forward
  with the updated arch for the metrics. BatchNorm runs in train mode in
  both forwards, so its running statistics move twice, as in the reference
  dev loop;
* eval step: ``model.eval()`` under ``torch.no_grad()``, running BatchNorm
  statistics, no dropout, no updates. On CUDA every supernet mixed op then
  runs the mixed-op kernel.

Each step takes its gradient with ``torch.autograd.grad`` with respect to
its own tensors only, hands it to its optimizer through ``.grad`` and clears
``.grad`` again, so neither step leaves gradients for the other.

Batches are dicts of device tensors with a fixed batch size; a final
partial batch is zero-padded and carries a ``mask`` row-validity vector.
The padded rows go through the model (BatchNorm statistics include them,
as in the JAX step), while the loss and the metric counts are weighted by
the mask. Counts stay on the device; the loop fetches them once a phase.

The weight optimizer is ``torch.optim.Adam(weight_decay=wd)``: L2 decay
added to the gradient before the moments, the same arithmetic as the JAX
package's ``torch_adam`` followed by ``p - eta * u``, with the learning
rate set to the scheduler's eta before each step. The arch optimizer is
Adam(lr, betas=(0.5, 0.999), weight_decay).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bmnas_tpu_torch.models.supernet import ARCH_KEYS, ArchParams

Batch = Dict[str, torch.Tensor]
Counts = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """What the steps change: the model (parameters and BatchNorm running
    statistics), the arch tensors and the two optimizers."""
    model: nn.Module
    arch: Optional[ArchParams]
    opt_w: Optional[torch.optim.Optimizer]
    opt_arch: Optional[torch.optim.Optimizer]


def freeze(model: nn.Module, frozen_prefixes: Sequence[str]) -> None:
    """Stop autograd at the frozen top-level submodules: their parameters
    never get a gradient, so no step builds their backward."""
    for n, p in model.named_parameters():
        if n.split(".", 1)[0] in frozen_prefixes:
            p.requires_grad_(False)


def make_weight_optimizer(model: nn.Module, frozen_prefixes: Sequence[str],
                          weight_decay: float) -> torch.optim.Optimizer:
    """Adam over the parameters outside the frozen top-level submodules;
    the learning rate is the scheduler's, set by each weight step."""
    params = [p for n, p in model.named_parameters()
              if n.split(".", 1)[0] not in frozen_prefixes]
    return torch.optim.Adam(params, lr=0.0, weight_decay=weight_decay)


def make_arch_optimizer(arch: ArchParams, lr: float, weight_decay: float
                        ) -> torch.optim.Optimizer:
    """Adam(lr, betas=(0.5, 0.999), weight_decay) over the arch tensors."""
    return torch.optim.Adam([arch[k] for k in ARCH_KEYS], lr=lr,
                            betas=(0.5, 0.999), weight_decay=weight_decay)


# Criteria: (logits, labels, mask) -> scalar; ``mask`` is the (B,) row
# validity. With a full mask they equal the torch criteria.

def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """BCEWithLogitsLoss: mean over all elements of the valid rows."""
    per_row = F.binary_cross_entropy_with_logits(
        logits, labels, reduction="none").mean(dim=-1)
    return (per_row * mask).sum() / mask.sum().clamp(min=1.0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """CrossEntropyLoss with integer labels, masked mean."""
    per_row = F.cross_entropy(logits, labels.long(), reduction="none")
    return (per_row * mask).sum() / mask.sum().clamp(min=1.0)


@dataclasses.dataclass(frozen=True)
class StepFunctions:
    """weight_step(state, batch, eta) -> counts
    arch_step(state, batch)        -> counts   [search dev phase]
    eval_step(state, batch)        -> counts   [model.eval()]

    ``counts`` holds the task's metric counts plus 'loss_sum' (the loss
    times the valid rows) and 'valid' (the number of valid rows).
    """
    weight_step: Callable[[TrainState, Batch, float], Counts]
    arch_step: Callable[[TrainState, Batch], Counts]
    eval_step: Callable[[TrainState, Batch], Counts]


def _step_with(optimizer: torch.optim.Optimizer,
               tensors: Sequence[torch.Tensor],
               grads: Tuple[torch.Tensor, ...]) -> None:
    """One optimizer step on ``grads``, leaving no ``.grad`` behind."""
    for t, g in zip(tensors, grads):
        t.grad = g
    optimizer.step()
    for t in tensors:
        t.grad = None


def build_step_functions(criterion: Callable, counts_fn: Callable
                         ) -> StepFunctions:
    """The three steps for one task model. ``criterion(logits, labels,
    mask)`` is the loss; ``counts_fn(logits, labels, mask)`` the metric
    counts, summed over batches by the loop."""

    def _counts(logits, loss, batch, mask) -> Counts:
        counts = dict(counts_fn(logits.detach(), batch["label"], mask))
        counts["loss_sum"] = loss.detach() * mask.sum()
        counts["valid"] = mask.sum()
        return counts

    def weight_step(state: TrainState, batch: Batch, eta: float) -> Counts:
        model = state.model.train()
        params = [p for g in state.opt_w.param_groups for p in g["params"]]
        mask = batch["mask"]
        logits = model(batch, state.arch)
        loss = criterion(logits, batch["label"], mask)
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        for group in state.opt_w.param_groups:
            group["lr"] = float(eta)
        _step_with(state.opt_w, params, grads)
        return _counts(logits, loss, batch, mask)

    def arch_step(state: TrainState, batch: Batch) -> Counts:
        model = state.model.train()
        arch = [state.arch[k] for k in ARCH_KEYS]
        mask = batch["mask"]
        loss = criterion(model(batch, state.arch), batch["label"], mask)
        _step_with(state.opt_arch, arch, torch.autograd.grad(loss, arch))
        # the metric forward: updated arch, second BatchNorm update
        with torch.no_grad():
            logits = model(batch, state.arch)
            loss = criterion(logits, batch["label"], mask)
        return _counts(logits, loss, batch, mask)

    def eval_step(state: TrainState, batch: Batch) -> Counts:
        model = state.model.eval()
        mask = batch["mask"]
        with torch.no_grad():
            logits = model(batch, state.arch)
            loss = criterion(logits, batch["label"], mask)
        return _counts(logits, loss, batch, mask)

    return StepFunctions(weight_step=weight_step, arch_step=arch_step,
                         eval_step=eval_step)
