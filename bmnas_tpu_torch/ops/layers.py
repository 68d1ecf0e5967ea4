"""Auxiliary layers: reshape-input projections, poolings, norms.

Port of ``bmnas_tpu/ops/layers.py``. Public layout stays channels-last:
``(B, L, C)`` sequences and ``(B, H, W, C)`` maps. Submodules carry the
flax scope names (``Dense_0``, ``BatchNorm_0``) so that
``utils/convert.py`` maps weights mechanically.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator, List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _adaptive_bins(in_size: int, out_size: int) -> List[Tuple[int, int]]:
    """AdaptiveMaxPool bin bounds: [floor(i*I/O), ceil((i+1)*I/O))."""
    return [(i * in_size // out_size, -(-(i + 1) * in_size // out_size))
            for i in range(out_size)]


def adaptive_max_pool_1d(x: torch.Tensor, out_size: int, axis: int
                         ) -> torch.Tensor:
    """torch AdaptiveMaxPool1d along any axis (the reference's semantics),
    as the JAX package computes it: a slice max per static bin, stacked.

    ``F.adaptive_max_pool1d`` gives the same values, but its CUDA backward
    adds by atomics in no fixed order and sends a tie's whole gradient to
    one element; ``amax`` over a slice has no scatter and splits a tie's
    gradient evenly, as ``jax.grad`` of the JAX pool does. Where the bins
    are disjoint and equal (``in_size % out_size == 0``) the slices are one
    ``amax`` over a split axis, with the same values and gradient.
    """
    axis = axis % x.dim()
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    if in_size % out_size == 0:
        return x.unflatten(axis, (out_size, in_size // out_size)).amax(
            dim=axis + 1)
    return torch.stack([x.narrow(axis, s, e - s).amax(dim=axis)
                        for s, e in _adaptive_bins(in_size, out_size)],
                       dim=axis)


def adaptive_max_pool_2d(x: torch.Tensor, out_hw: Tuple[int, int]
                         ) -> torch.Tensor:
    """Adaptive max pool over the spatial axes of an NHWC map."""
    return adaptive_max_pool_1d(adaptive_max_pool_1d(x, out_hw[0], 1),
                                out_hw[1], 2)


def interpolate_nearest_1d(x: torch.Tensor, out_size: int, axis: int
                           ) -> torch.Tensor:
    """F.interpolate(mode='nearest') along one axis: idx = floor(i*I/O)."""
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    idx = torch.arange(out_size, device=x.device) * in_size // out_size
    return x.index_select(axis, idx)


def layer_norm_2d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Per-sample LayerNorm over the last two axes, biased variance."""
    mean = x.mean(dim=(-2, -1), keepdim=True)
    var = (x - mean).square().mean(dim=(-2, -1), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


class LayerNorm2D(nn.Module):
    """LayerNorm over the last two axes with a per-position (L, C) affine
    (``nn.LayerNorm([C, L])`` of the reference on its (B, C, L) layout)."""

    def __init__(self, L: int, C: int, eps: float = 1e-5, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(L, C, **kw))
        self.bias = nn.Parameter(torch.zeros(L, C, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_2d(x, self.weight, self.bias, self.eps)


_RECOMPUTING = threading.local()


@contextlib.contextmanager
def recomputing() -> Iterator[None]:
    """Marks a forward that recomputes activations for a backward
    (``torch.utils.checkpoint``): train-mode BatchNorms inside it normalize
    with the batch statistics as before, but leave their running
    statistics alone, which the first forward already moved (flax's
    ``nn.remat`` keeps only the forward's update)."""
    prev = getattr(_RECOMPUTING, "on", False)
    _RECOMPUTING.on = True
    try:
        yield
    finally:
        _RECOMPUTING.on = prev


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last (channel) axis with the JAX package's
    semantics (flax ``nn.BatchNorm(axis=-1, momentum=0.9)``, eps 1e-5).

    Every leading axis is a batch axis, and every row counts: the padded
    rows of a final batch are part of the statistics, as in the JAX step.
    In train mode it normalizes with the biased batch variance and moves
    the running statistics toward the batch mean and the *biased* batch
    variance: ``r <- 0.9 r + 0.1 stat`` (torch momentum 0.1). Stock
    ``nn.BatchNorm1d`` would move ``running_var`` toward the unbiased
    variance, which drifts eval outputs from the JAX package by n/(n-1).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = x.shape
        return self._norm(x.reshape(-1, shape[-1])).reshape(shape)

    def _norm(self, x: torch.Tensor) -> torch.Tensor:
        """Normalize ``(N, C, ...)`` over every axis but 1."""
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        out = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                           self.eps)
        if getattr(_RECOMPUTING, "on", False):
            return out
        with torch.no_grad():
            axes = [d for d in range(x.dim()) if d != 1]
            var, mean = torch.var_mean(x.float(), dim=axes, correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return out


class ChannelsFirstBatchNorm(BatchNorm):
    """The same BatchNorm on a channels-first ``(N, C, ...)`` map (the
    convolution stacks run channels-first on cuDNN)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._norm(x)


class GlobalPooling2D(nn.Module):
    """Mean over the spatial axes: (B, H, W, C) -> (B, C)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2))


class Maxout(nn.Module):
    """Linear(d -> features*pool_size), then max over pool_size. The output
    is viewed as (features, pool_size), the reference's order."""

    def __init__(self, in_features: int, features: int, pool_size: int,
                 device=None, dtype=None):
        super().__init__()
        self.features = features
        self.pool_size = pool_size
        self.Dense_0 = nn.Linear(in_features, features * pool_size,
                                 device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.Dense_0(x)
        out = out.reshape(*out.shape[:-1], self.features, self.pool_size)
        return out.amax(dim=-1)


class _ProjectBNReLU(nn.Module):
    """Linear over C -> BatchNorm -> ReLU -> dropout."""

    def __init__(self, C_in: int, C: int, drpt: float, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.Dense_0 = nn.Linear(C_in, C, **kw)
        self.BatchNorm_0 = BatchNorm(C, **kw)
        self.dropout = nn.Dropout(drpt)

    def project(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.BatchNorm_0(self.Dense_0(x)))
        return self.dropout(x)


class ReshapeInputLayer(_ProjectBNReLU):
    """Project a ``(B, T, ..., C_in)`` feature map to ``(B, L, C)``: max over
    the flattened spatial axes, adaptive max pool T -> L, nearest
    interpolation (identity after the pool), then the projection."""

    def __init__(self, C_in: int, C: int, L: int, drpt: float, device=None,
                 dtype=None):
        super().__init__(C_in, C, drpt, device=device, dtype=dtype)
        self.L = L

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C_in = x.shape[0], x.shape[-1]
        if x.dim() == 2:
            x = x[:, None, :]
        x = x.reshape(B, x.shape[1], -1, C_in).amax(dim=2)
        x = adaptive_max_pool_1d(x, self.L, axis=1)
        x = interpolate_nearest_1d(x, self.L, axis=1)
        return self.project(x)


class ReshapeInputLayerMMIMDB(_ProjectBNReLU):
    """MM-IMDB variant: pool the spatial axes to sqrt(L) x sqrt(L) bins.

    ``(B, C_in)`` vectors are 1x1 maps, so pooling replicates them into all
    L bins, as the reference's AdaptiveMaxPool2d does on a (C, 1, 1) map.
    Here they are replicated by ``expand``: the same values and input
    gradient as the pool, with one broadcast in place of L one-element
    slices. Maps go through :func:`adaptive_max_pool_2d`, whose backward
    has no scatter, so found retraining (which trains both backbones
    through this layer) is deterministic on CUDA.
    """

    def __init__(self, C_in: int, C: int, L: int, drpt: float, device=None,
                 dtype=None):
        super().__init__(C_in, C, drpt, device=device, dtype=dtype)
        self.pool_size = int(math.sqrt(L * 1.0))
        if self.pool_size * self.pool_size != L:
            raise ValueError(f"L must be a perfect square, got {L}")
        self.L = L

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C_in = x.shape[0], x.shape[-1]
        if x.dim() == 2:
            return self.project(x[:, None, :].expand(B, self.L, C_in))
        if x.dim() == 3:
            x = x[:, :, None, :]
        x = adaptive_max_pool_2d(x, (self.pool_size, self.pool_size))
        return self.project(x.reshape(B, self.L, C_in))
