"""DARTS-style fusion supernet (search phase).

Port of ``bmnas_tpu/models/supernet.py``: SearchNodeCell, FusionCell and
FusionNetwork, channels-last ``(B, L, C)``. Submodules carry the flax scope
names (``cell.step_node_i.NodeMixedOp_k``, ``LayerNorm2D_0``, and
``Dense_0``/``BatchNorm_0`` when ``node_multiplier != 1``), so
``utils/convert.py`` maps a JAX checkpoint one to one.

The architecture parameters (alpha/beta/gamma) live outside the module, as
in the JAX package: a dict of leaf tensors made by :func:`init_arch_params`
and passed into ``forward``. The weight step differentiates the module's
parameters only, the arch step these tensors only.

Each step's mixed-edge fan-out is one stacked contraction
(``ops.fusion_ops.edge_weighted_sum``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from bmnas_tpu_torch import genotype as G
from bmnas_tpu_torch.ops.fusion_ops import NodeMixedOp, edge_weighted_sum
from bmnas_tpu_torch.ops.layers import BatchNorm, LayerNorm2D

ArchParams = Dict[str, torch.Tensor]
ARCH_KEYS = ("alphas", "betas", "gammas")


def outer_num_edges(steps: int, num_input_nodes: int) -> int:
    return sum(num_input_nodes + i for i in range(steps))


def inner_num_edges(node_steps: int, num_input_nodes: int = 2) -> int:
    return sum(num_input_nodes + i for i in range(node_steps))


def init_arch_params(generator: torch.Generator, steps: int,
                     num_input_nodes: int, node_steps: int,
                     device=None) -> ArchParams:
    """1e-3 * N(0, 1) fp32 leaf tensors that require grad, drawn from
    ``generator`` (on the CPU, then moved to ``device``). Shapes:
      alphas: (sum_i (num_input_nodes + i), |PRIMITIVES|)
      betas:  (steps, sum_i (2 + i), |STEP_EDGE_PRIMITIVES|)
      gammas: (steps, node_steps, |STEP_STEP_PRIMITIVES|)
    """
    shapes = {
        "alphas": (outer_num_edges(steps, num_input_nodes),
                   len(G.PRIMITIVES)),
        "betas": (steps, inner_num_edges(node_steps),
                  len(G.STEP_EDGE_PRIMITIVES)),
        "gammas": (steps, node_steps, len(G.STEP_STEP_PRIMITIVES)),
    }
    return {k: (1e-3 * torch.randn(s, generator=generator))
            .to(device).requires_grad_()
            for k, s in shapes.items()}


def derive_genotype_from_arch(arch: ArchParams, steps: int, multiplier: int,
                              num_input_nodes: int, node_steps: int,
                              node_multiplier: int) -> G.Genotype:
    """Host-side genotype derivation from the arch tensors."""
    host = {k: arch[k].detach().float().cpu().numpy() for k in ARCH_KEYS}
    return G.derive_genotype(
        host["alphas"], [host["betas"][i] for i in range(steps)],
        [host["gammas"][i] for i in range(steps)], steps, multiplier,
        num_input_nodes, node_steps, node_multiplier)


class SearchNodeCell(nn.Module):
    """Inner searchable mini-DAG: ``node_steps`` mixed ops, each fed the
    beta-weighted sum of the states so far as both of its inputs."""

    def __init__(self, node_steps: int, node_multiplier: int, C: int, L: int,
                 drpt: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.node_steps = node_steps
        self.node_multiplier = node_multiplier
        for i in range(node_steps):
            self.add_module(f"NodeMixedOp_{i}", NodeMixedOp(C, L, drpt, **kw))
        if node_multiplier != 1:
            self.Dense_0 = nn.Linear(node_multiplier * C, C, **kw)
            self.BatchNorm_0 = BatchNorm(C, **kw)
            self.dropout = nn.Dropout(drpt)
        self.LayerNorm2D_0 = LayerNorm2D(L, C, **kw)

    def forward(self, x: torch.Tensor, y: torch.Tensor, beta_w: torch.Tensor,
                gamma_w: torch.Tensor) -> torch.Tensor:
        # beta_w: (k_inner, 2) softmaxed; gamma_w: (node_steps, 4) softmaxed
        states = [x, y]
        offset = 0
        for i in range(self.node_steps):
            step_input = edge_weighted_sum(
                torch.stack(states), beta_w[offset:offset + len(states), 1])
            s = getattr(self, f"NodeMixedOp_{i}")(step_input, step_input,
                                                  gamma_w[i])
            offset += len(states)
            states.append(s)
        out = torch.cat(states[-self.node_multiplier:], dim=-1)
        if self.node_multiplier != 1:
            out = self.dropout(F.relu(self.BatchNorm_0(self.Dense_0(out))))
        return self.LayerNorm2D_0(out + x)


class FusionCell(nn.Module):
    """Outer searchable cell: ``steps`` step nodes over the alpha-weighted
    sums of the states so far, then concat of the last ``multiplier``
    states, LayerNorm, ReLU and an L-major flatten."""

    def __init__(self, steps: int, multiplier: int, num_input_nodes: int,
                 node_steps: int, node_multiplier: int, C: int, L: int,
                 drpt: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.steps = steps
        self.multiplier = multiplier
        for i in range(steps):
            self.add_module(f"step_node_{i}", SearchNodeCell(
                node_steps, node_multiplier, C, L, drpt, **kw))
        self.LayerNorm2D_0 = LayerNorm2D(L, multiplier * C, **kw)

    def forward(self, input_features: Sequence[torch.Tensor],
                arch_w: ArchParams) -> torch.Tensor:
        alpha_w = arch_w["alphas"]  # (k_outer, 2) softmaxed
        states: List[torch.Tensor] = list(input_features)
        offset = 0
        for i in range(self.steps):
            step_input = edge_weighted_sum(
                torch.stack(states), alpha_w[offset:offset + len(states), 1])
            s = getattr(self, f"step_node_{i}")(
                step_input, step_input, arch_w["betas"][i],
                arch_w["gammas"][i])
            offset += len(states)
            states.append(s)
        out = torch.cat(states[-self.multiplier:], dim=-1)
        out = F.relu(self.LayerNorm2D_0(out))
        return out.reshape(out.shape[0], -1)


class FusionNetwork(nn.Module):
    """Supernet wrapper: softmaxes the arch tensors and runs the one cell,
    named ``cell``."""

    def __init__(self, steps: int, multiplier: int, num_input_nodes: int,
                 num_keep_edges: int, node_steps: int, node_multiplier: int,
                 C: int, L: int, drpt: float, device=None, dtype=None):
        super().__init__()
        self.num_input_nodes = num_input_nodes
        self.cell = FusionCell(steps, multiplier, num_input_nodes, node_steps,
                               node_multiplier, C, L, drpt, device=device,
                               dtype=dtype)

    def forward(self, input_features: Sequence[torch.Tensor],
                arch: ArchParams) -> torch.Tensor:
        if len(input_features) != self.num_input_nodes:
            raise ValueError(f"expected {self.num_input_nodes} input "
                             f"features, got {len(input_features)}")
        arch_w = {k: arch[k].softmax(dim=-1) for k in ARCH_KEYS}
        return self.cell(input_features, arch_w)
