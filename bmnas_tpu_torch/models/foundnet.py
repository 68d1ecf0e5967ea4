"""Found fusion network built from a discrete Genotype.

Port of ``bmnas_tpu/models/foundnet.py``: FoundNodeCell, the four
``--node_variant`` ablation nodes, FoundFusionCell and FoundFusionNetwork.
Submodules carry the flax scope names (``EdgeOp_k``, ``step_node_i``,
``ConcatFC_0``, ``LayerNorm2D_0``, ...), so ``utils/convert.py`` maps a
JAX checkpoint one to one.

An eval-mode FoundNodeCell on CUDA always runs the found-cell kernel
(``ops/kernels/node_mixed.found_node_cell_fused``); ``fused_eval=True``
sends CPU eval forwards through the same wrapper, which runs the kernel's
plain version there. A genotype the kernel cannot host is refused when the
cell is built for CUDA or with ``fused_eval``, never run some other way.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bmnas_tpu_torch import genotype as G
from bmnas_tpu_torch.ops.fusion_ops import (
    STEP_OP_CLASS,
    STEP_OPS,
    EdgeOp,
    LinearGLU,
    ScaledDotAttn,
)
from bmnas_tpu_torch.ops.kernels.node_mixed import (
    FUSABLE_STEP_OPS,
    FoundCellParams,
    found_cell_blocker,
    found_cell_steps_cfg,
    found_node_cell_fused,
    fuse_bn_into_dense,
    stack_step_params,
)
from bmnas_tpu_torch.ops.layers import BatchNorm, LayerNorm2D


def _freeze(genotype: G.Genotype) -> Tuple:
    """A genotype as nested tuples."""
    steps = tuple(
        (tuple(map(tuple, s.inner_edges)), tuple(s.inner_steps),
         tuple(s.inner_concat))
        for s in genotype.steps)
    return (tuple(map(tuple, genotype.edges)), steps, tuple(genotype.concat))


def _f32(t: torch.Tensor) -> torch.Tensor:
    """A detached fp32 copy (never an alias of a parameter)."""
    return t.detach().float().clone()


def _fold_dense_bn(dense: nn.Linear, bn: BatchNorm):
    """(in, out) fp32 kernel and bias of Linear -> eval BatchNorm."""
    return fuse_bn_into_dense(
        _f32(dense.weight).t(), _f32(dense.bias), _f32(bn.weight),
        _f32(bn.bias), _f32(bn.running_mean), _f32(bn.running_var), bn.eps)


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class FoundNodeCell(nn.Module):
    """Fixed inner DAG from a StepGenotype."""

    def __init__(self, inner_edges, inner_steps, node_steps: int,
                 node_multiplier: int, C: int, L: int, drpt: float,
                 fused_eval: bool = False, device=None, dtype=None):
        super().__init__()
        self.inner_edges = tuple(map(tuple, inner_edges))
        self.inner_steps = tuple(inner_steps)
        self.node_steps = node_steps
        self.node_multiplier = node_multiplier
        self.C, self.L = C, L
        self.fused_eval = fused_eval
        self.blocker = found_cell_blocker(self.inner_edges, self.inner_steps,
                                          C, L, node_multiplier)
        if self.blocker and (fused_eval or _is_cuda(device)):
            raise ValueError("the found-cell kernel cannot host this "
                             f"genotype: {self.blocker}")
        kw = dict(device=device, dtype=dtype)
        for k, (kind, _) in enumerate(self.inner_edges[:2 * node_steps]):
            self.add_module(f"EdgeOp_{k}", EdgeOp(kind, C, drpt, **kw))
        counters = {}
        self.step_names: List[str] = []
        for op in self.inner_steps[:node_steps]:
            cls = STEP_OP_CLASS[op]
            name = f"{cls}_{counters.get(cls, 0)}"
            counters[cls] = counters.get(cls, 0) + 1
            self.add_module(name, STEP_OPS[op](C, L, drpt, **kw))
            self.step_names.append(name)
        if node_multiplier != 1:
            self.Dense_0 = nn.Linear(node_multiplier * C, C, **kw)
            self.BatchNorm_0 = BatchNorm(C, **kw)
            self.dropout = nn.Dropout(drpt)
        self.LayerNorm2D_0 = LayerNorm2D(L, C, **kw)
        self.steps_cfg = (None if self.blocker else
                          found_cell_steps_cfg(self.inner_edges,
                                               self.inner_steps))
        self._folded: Optional[FoundCellParams] = None

    # -- folded parameters: built once, dropped whenever they may go stale
    def fold(self) -> FoundCellParams:
        """Fold the eval-mode BatchNorms into the dense weights (in fp32,
        stored in the parameters' dtype) and keep the result."""
        with torch.no_grad():
            like = self.LayerNorm2D_0.weight
            steps = []
            for op, name in zip(self.inner_steps, self.step_names):
                mod = getattr(self, name)
                branch = FUSABLE_STEP_OPS[op]
                st = {}
                if branch == 1:
                    st = {"ln1_scale": _f32(mod.LayerNorm2D_0.weight),
                          "ln1_bias": _f32(mod.LayerNorm2D_0.bias)}
                elif branch in (2, 3):
                    k, b = _fold_dense_bn(mod.Dense_0, mod.BatchNorm_0)
                    pre = "glu" if branch == 2 else "cfc"
                    st = {f"{pre}_kernel": k, f"{pre}_bias": b}
                steps.append(st)
            oc_k = oc_b = None
            if self.node_multiplier != 1:
                oc_k, oc_b = _fold_dense_bn(self.Dense_0, self.BatchNorm_0)
            p = FoundCellParams(
                **stack_step_params(steps, self.L, self.C, like.float()),
                oc_kernel=oc_k, oc_bias=oc_b,
                ln2_scale=_f32(self.LayerNorm2D_0.weight),
                ln2_bias=_f32(self.LayerNorm2D_0.bias))
            self._folded = p.to(dtype=like.dtype)
        return self._folded

    def train(self, mode: bool = True):
        super().train(mode)
        self._folded = None
        if not mode and self.LayerNorm2D_0.weight.is_cuda:
            self._check_hostable()
            self.fold()
        return self

    def _apply(self, fn, *args, **kwargs):
        self._folded = None
        return super()._apply(fn, *args, **kwargs)

    def _load_from_state_dict(self, *args, **kwargs):
        self._folded = None
        return super()._load_from_state_dict(*args, **kwargs)

    def _check_hostable(self):
        if self.blocker:
            raise ValueError("the found-cell kernel cannot host this "
                             f"genotype: {self.blocker}")

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if not self.training and (x.is_cuda or self.fused_eval):
            self._check_hostable()
            p = self._folded if self._folded is not None else self.fold()
            return found_node_cell_fused(x, y, p, self.steps_cfg,
                                         self.node_multiplier)
        states = [x, y]
        for i, name in enumerate(self.step_names):
            _, idx_x = self.inner_edges[2 * i]
            _, idx_y = self.inner_edges[2 * i + 1]
            in_x = getattr(self, f"EdgeOp_{2 * i}")(states[idx_x])
            in_y = getattr(self, f"EdgeOp_{2 * i + 1}")(states[idx_y])
            states.append(getattr(self, name)(in_x, in_y))
        out = torch.cat(states[-self.node_multiplier:], dim=-1)
        if self.node_multiplier != 1:
            out = self.dropout(F.relu(self.BatchNorm_0(self.Dense_0(out))))
        return self.LayerNorm2D_0(out + x)


# ---------------------------------------------------------------------------
# Ablation fusion-node variants (bmnas_tpu/models/foundnet.py:134-186).
# ---------------------------------------------------------------------------

class DartsFusionNode(nn.Module):
    """x + y."""

    def forward(self, x, y):
        return x + y


class MfasFusionNode(nn.Module):
    """cat -> Linear -> BN -> ReLU -> dropout."""

    def __init__(self, C: int, drpt: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.Dense_0 = nn.Linear(2 * C, C, **kw)
        self.BatchNorm_0 = BatchNorm(C, **kw)
        self.dropout = nn.Dropout(drpt)

    def forward(self, x, y):
        out = self.BatchNorm_0(self.Dense_0(torch.cat([x, y], dim=-1)))
        return self.dropout(F.relu(out))


class AoaFusionNode(nn.Module):
    """Attention, then GLU over (x, attention output)."""

    def __init__(self, C: int, L: int, drpt: float, device=None, dtype=None):
        super().__init__()
        self.ScaledDotAttn_0 = ScaledDotAttn(C, L, device=device, dtype=dtype)
        self.LinearGLU_0 = LinearGLU(C, drpt, device=device, dtype=dtype)

    def forward(self, x, y):
        return self.LinearGLU_0(x, self.ScaledDotAttn_0(x, y))


class TwoHeadAttnFusionNode(nn.Module):
    """Two attention heads, concat, Linear -> BN -> ReLU -> dropout."""

    def __init__(self, C: int, L: int, drpt: float, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.ScaledDotAttn_0 = ScaledDotAttn(C, L, **kw)
        self.ScaledDotAttn_1 = ScaledDotAttn(C, L, **kw)
        self.Dense_0 = nn.Linear(2 * C, C, **kw)
        self.BatchNorm_0 = BatchNorm(C, **kw)
        self.dropout = nn.Dropout(drpt)

    def forward(self, x, y):
        out = torch.cat([self.ScaledDotAttn_0(x, y),
                         self.ScaledDotAttn_1(x, y)], dim=-1)
        out = self.BatchNorm_0(self.Dense_0(out))
        return self.dropout(F.relu(out))


NODE_VARIANTS = ("bmnas", "darts", "mfas", "aoa", "two_head_attn")


class FoundFusionCell(nn.Module):
    """Fixed outer cell compiled from genotype.edges."""

    def __init__(self, edges, steps_genes, concat, node_steps: int,
                 node_multiplier: int, C: int, L: int, drpt: float,
                 node_variant: str = "bmnas", fused_eval: bool = False,
                 device=None, dtype=None):
        super().__init__()
        if node_variant not in NODE_VARIANTS:
            raise ValueError(f"unknown node_variant {node_variant!r}")
        self.edges = tuple(map(tuple, edges))
        self.multiplier = len(concat)
        kw = dict(device=device, dtype=dtype)
        for k, (kind, _) in enumerate(self.edges):
            self.add_module(f"EdgeOp_{k}", EdgeOp(kind, C, drpt, **kw))
        for i in range(len(self.edges) // 2):
            if node_variant == "bmnas":
                inner_edges, inner_steps, _ = steps_genes[i]
                node = FoundNodeCell(inner_edges, inner_steps, node_steps,
                                     node_multiplier, C, L, drpt,
                                     fused_eval=fused_eval, **kw)
            elif node_variant == "darts":
                node = DartsFusionNode()
            elif node_variant == "mfas":
                node = MfasFusionNode(C, drpt, **kw)
            elif node_variant == "aoa":
                node = AoaFusionNode(C, L, drpt, **kw)
            else:
                node = TwoHeadAttnFusionNode(C, L, drpt, **kw)
            self.add_module(f"step_node_{i}", node)
        self.LayerNorm2D_0 = LayerNorm2D(L, self.multiplier * C, **kw)

    def forward(self, input_features: Sequence[torch.Tensor]) -> torch.Tensor:
        states = list(input_features)
        for i in range(len(self.edges) // 2):
            _, idx1 = self.edges[2 * i]
            _, idx2 = self.edges[2 * i + 1]
            h1 = getattr(self, f"EdgeOp_{2 * i}")(states[idx1])
            h2 = getattr(self, f"EdgeOp_{2 * i + 1}")(states[idx2])
            states.append(getattr(self, f"step_node_{i}")(h1, h2))
        out = torch.cat(states[-self.multiplier:], dim=-1)
        out = F.relu(self.LayerNorm2D_0(out))
        return out.reshape(out.shape[0], -1)


class FoundFusionNetwork(nn.Module):
    """Found-net wrapper: one FoundFusionCell named ``cell``."""

    def __init__(self, steps: int, multiplier: int, num_input_nodes: int,
                 num_keep_edges: int, node_steps: int, node_multiplier: int,
                 C: int, L: int, drpt: float, genotype: Tuple,
                 node_variant: str = "bmnas", fused_eval: bool = False,
                 device=None, dtype=None):
        super().__init__()
        self.num_input_nodes = num_input_nodes
        self.genotype = genotype
        edges, steps_genes, concat = genotype
        self.cell = FoundFusionCell(edges, steps_genes, concat, node_steps,
                                    node_multiplier, C, L, drpt,
                                    node_variant=node_variant,
                                    fused_eval=fused_eval, device=device,
                                    dtype=dtype)

    @classmethod
    def from_genotype(cls, genotype: G.Genotype, **kwargs
                      ) -> "FoundFusionNetwork":
        return cls(genotype=_freeze(genotype), **kwargs)

    def forward(self, input_features: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(input_features) != self.num_input_nodes:
            raise ValueError(f"expected {self.num_input_nodes} input "
                             f"features, got {len(input_features)}")
        return self.cell(input_features)

    def get_genotype(self) -> G.Genotype:
        edges, steps_genes, concat = self.genotype
        steps = [G.StepGenotype(inner_edges=[tuple(e) for e in ie],
                                inner_steps=list(isteps),
                                inner_concat=list(ic))
                 for (ie, isteps, ic) in steps_genes]
        return G.Genotype(edges=[tuple(e) for e in edges], steps=steps,
                          concat=list(concat))

    def referenced_input_nodes(self) -> Tuple[int, ...]:
        """Input indices the genotype's edges consume."""
        edges, _, _ = self.genotype
        return tuple(sorted({idx for _, idx in edges
                             if idx < self.num_input_nodes}))
