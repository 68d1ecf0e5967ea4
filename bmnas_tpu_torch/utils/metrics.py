"""Multilabel F1 from accumulated per-class counts, and accuracy.

Port of ``bmnas_tpu/utils/metrics.py`` (multilabel_counts, f1_from_counts,
accuracy_counts, topk_accuracy, AvgrageMeter): counts are summed per batch
(on the device that holds the predictions) and finalised on the host with
sklearn's formulas, ``zero_division=1`` by default as in the reference.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def multilabel_counts(preds: torch.Tensor, labels: torch.Tensor,
                      mask: Optional[torch.Tensor] = None
                      ) -> Dict[str, torch.Tensor]:
    """Per-class TP/FP/FN and per-sample F1 sums of one batch.

    preds/labels: (B, K) in {0, 1}; mask: optional (B,) row validity.
    """
    preds = preds.float()
    labels = labels.to(preds)
    if mask is None:
        mask = torch.ones(preds.shape[0], device=preds.device)
    mask = mask.to(preds)
    m = mask[:, None]
    tp_s = (preds * labels).sum(dim=1)
    denom_s = preds.sum(dim=1) + labels.sum(dim=1)
    f1_s = torch.where(denom_s > 0, 2.0 * tp_s / denom_s.clamp(min=1.0),
                       torch.ones_like(denom_s))
    return {
        "tp": (preds * labels * m).sum(dim=0),
        "fp": (preds * (1.0 - labels) * m).sum(dim=0),
        "fn": ((1.0 - preds) * labels * m).sum(dim=0),
        "samples_f1_sum": (f1_s * mask).sum(),
        "count": mask.sum(),
    }


def f1_from_counts(counts: Dict[str, object], average: str = "weighted",
                   zero_division: float = 1.0) -> float:
    as_np = lambda v: np.asarray(  # noqa: E731
        v.detach().cpu() if isinstance(v, torch.Tensor) else v, np.float64)
    tp, fp, fn = as_np(counts["tp"]), as_np(counts["fp"]), as_np(counts["fn"])
    denom = 2 * tp + fp + fn
    f1 = np.where(denom > 0, 2 * tp / np.maximum(denom, 1.0), zero_division)
    if average == "macro":
        return float(f1.mean())
    if average == "weighted":
        support = tp + fn
        total = support.sum()
        if total == 0:
            return float(zero_division)
        return float((f1 * support).sum() / total)
    if average == "samples":
        return float(as_np(counts["samples_f1_sum"])) / max(
            float(as_np(counts["count"])), 1.0)
    raise ValueError(f"unknown average {average!r}")


def accuracy_counts(logits: torch.Tensor, labels: torch.Tensor,
                    mask: Optional[torch.Tensor] = None
                    ) -> Dict[str, torch.Tensor]:
    """Correct argmax predictions against integer labels, and the number
    of valid rows, of one batch; ``mask`` (B,) marks the valid rows."""
    if mask is None:
        mask = torch.ones(logits.shape[0], device=logits.device)
    mask = mask.float()
    hit = (logits.argmax(dim=-1) == labels.long()).float()
    return {"correct": (hit * mask).sum(), "count": mask.sum()}


def topk_accuracy(logits, labels, topk=(1,)) -> list:
    """Top-k accuracies in percent, one per k (numpy or tensors)."""
    as_np = lambda v: np.asarray(  # noqa: E731
        v.detach().cpu() if isinstance(v, torch.Tensor) else v)
    logits, labels = as_np(logits), as_np(labels)
    order = np.argsort(-logits, axis=-1)
    return [100.0 * (order[:, :k] == labels[:, None]).any(axis=1).mean()
            for k in topk]


class AvgrageMeter:
    """Running average (the reference's spelling)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.avg = 0.0
        self.sum = 0.0
        self.cnt = 0

    def update(self, val, n=1):
        self.sum += val * n
        self.cnt += n
        self.avg = self.sum / self.cnt


def count_parameters(module: torch.nn.Module) -> int:
    """Number of scalars in a module's parameters."""
    return sum(p.numel() for p in module.parameters())
