"""Fusion primitives: outer edge ops and inner two-input fusion ops.

Port of ``bmnas_tpu/ops/fusion_ops.py`` (EdgeOp, SumOp, ScaledDotAttn,
LinearGLU, ConcatFC, STEP_OPS, the supernet's NodeMixedOp and
edge_weighted_sum). Inputs are channels-last ``(B, L, C)``; every 1x1
Conv1d of the reference is a Linear over C. Submodules carry the flax scope
names so weights map one to one.

An eval-mode NodeMixedOp on CUDA runs the mixed-op kernel
(``ops/kernels/node_mixed.node_mixed_op_fused``, ``csrc/node_mixed.cu``)
with its BatchNorms folded into the dense weights; in train mode, and in
eval mode on the CPU, it runs the composite of the four inner ops.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from bmnas_tpu_torch.genotype import STEP_STEP_PRIMITIVES
from bmnas_tpu_torch.ops.kernels.node_mixed import (
    node_mixed_op_fused,
    params_from_module,
)
from bmnas_tpu_torch.ops.layers import BatchNorm, LayerNorm2D

EDGE_OPS = ["none", "fc_relu", "fc_mish", "skip"]


def edge_weighted_sum(states: torch.Tensor, skip_weights: torch.Tensor
                      ) -> torch.Tensor:
    """The mixed edge sum over a stack of states: with PRIMITIVES = [none,
    skip] each mixed edge is ``w_none * 0 + w_skip * x``, so a step's input
    is one contraction ``einsum('n,nblc->blc', w[:, skip], states)``.

    states: (N, B, L, C); skip_weights: (N,) softmaxed 'skip' column.
    """
    return torch.einsum("n,nblc->blc", skip_weights, states)


class EdgeOp(nn.Module):
    """One named edge op: 'none' -> zeros, 'skip' -> identity,
    'fc_relu'/'fc_mish' -> Linear + activation + BN + dropout."""

    def __init__(self, kind: str, C: int, drpt: float, device=None,
                 dtype=None):
        super().__init__()
        if kind not in EDGE_OPS:
            raise ValueError(f"unknown edge op {kind!r}")
        self.kind = kind
        if kind in ("fc_relu", "fc_mish"):
            kw = dict(device=device, dtype=dtype)
            self.Dense_0 = nn.Linear(C, C, **kw)
            self.BatchNorm_0 = BatchNorm(C, **kw)
            self.dropout = nn.Dropout(drpt)

    @property
    def has_params(self) -> bool:
        return self.kind in ("fc_relu", "fc_mish")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "none":
            return torch.zeros_like(x)
        if self.kind == "skip":
            return x
        out = self.Dense_0(x)
        out = F.relu(out) if self.kind == "fc_relu" else F.mish(out)
        return self.dropout(self.BatchNorm_0(out))


class SumOp(nn.Module):
    """x + y."""

    def forward(self, x, y):
        return x + y


class ScaledDotAttn(nn.Module):
    """softmax(x y^T / sqrt(C)) y over the L axis, dropout 0.1 (the
    reference's fixed rate), then LayerNorm2D."""

    def __init__(self, C: int, L: int, device=None, dtype=None):
        super().__init__()
        self.dropout = nn.Dropout(0.1)
        self.LayerNorm2D_0 = LayerNorm2D(L, C, device=device, dtype=dtype)

    def forward(self, x, y):
        scores = torch.einsum("blc,bmc->blm", x, y) / math.sqrt(x.shape[-1])
        out = torch.einsum("blm,bmc->blc", scores.softmax(dim=-1), y)
        return self.LayerNorm2D_0(self.dropout(out))


class LinearGLU(nn.Module):
    """concat -> Linear(2C -> 2C) -> BN -> GLU (first half gated by the
    sigmoid of the second) -> dropout."""

    def __init__(self, C: int, drpt: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.Dense_0 = nn.Linear(2 * C, 2 * C, **kw)
        self.BatchNorm_0 = BatchNorm(2 * C, **kw)
        self.dropout = nn.Dropout(drpt)

    def forward(self, x, y):
        out = self.BatchNorm_0(self.Dense_0(torch.cat([x, y], dim=-1)))
        return self.dropout(F.glu(out, dim=-1))


class ConcatFC(nn.Module):
    """concat -> Linear(2C -> C) -> BN -> ReLU -> dropout."""

    def __init__(self, C: int, drpt: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.Dense_0 = nn.Linear(2 * C, C, **kw)
        self.BatchNorm_0 = BatchNorm(C, **kw)
        self.dropout = nn.Dropout(drpt)

    def forward(self, x, y):
        out = self.BatchNorm_0(self.Dense_0(torch.cat([x, y], dim=-1)))
        return self.dropout(F.relu(out))


STEP_OPS: Dict[str, Callable[..., nn.Module]] = {
    "Sum": lambda C, L, drpt, **kw: SumOp(),
    "ScaleDotAttn": lambda C, L, drpt, **kw: ScaledDotAttn(C, L, **kw),
    "LinearGLU": lambda C, L, drpt, **kw: LinearGLU(C, drpt, **kw),
    "ConcatFC": lambda C, L, drpt, **kw: ConcatFC(C, drpt, **kw),
    # legacy spelling of ConcatFC in old reference genotypes
    "cat_conv_relu": lambda C, L, drpt, **kw: ConcatFC(C, drpt, **kw),
}

# flax auto-name class of each inner op (per-class counters name the
# submodules: two ConcatFC steps -> ConcatFC_0, ConcatFC_1)
STEP_OP_CLASS = {"Sum": "SumOp", "ScaleDotAttn": "ScaledDotAttn",
                 "LinearGLU": "LinearGLU", "ConcatFC": "ConcatFC",
                 "cat_conv_relu": "ConcatFC"}


class NodeMixedOp(nn.Module):
    """gamma-weighted sum of all four inner ops (the supernet's continuous
    relaxation): ``SumOp_0``, ``ScaledDotAttn_0``, ``LinearGLU_0``,
    ``ConcatFC_0``.

    Train mode runs the composite. Eval mode runs the mixed-op kernel on
    CUDA and the composite on the CPU. The kernel takes the BatchNorms
    folded into the dense weights, folded anew on every eval forward:
    the search changes the weights and running statistics at every step.
    """

    def __init__(self, C: int, L: int, drpt: float, device=None, dtype=None):
        super().__init__()
        self.branch_names = []
        for op in STEP_STEP_PRIMITIVES:
            name = f"{STEP_OP_CLASS[op]}_0"
            self.add_module(name, STEP_OPS[op](C, L, drpt, device=device,
                                               dtype=dtype))
            self.branch_names.append(name)

    def forward(self, x: torch.Tensor, y: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
        if not self.training and x.is_cuda:
            return node_mixed_op_fused(x, y, weights,
                                       params_from_module(self))
        outs = [getattr(self, n)(x, y) for n in self.branch_names]
        return torch.einsum("k,kblc->blc", weights, torch.stack(outs))
