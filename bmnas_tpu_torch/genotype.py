"""Genotype schema and derivation rules for BM-NAS (PyTorch port).

The port's own copy of ``bmnas_tpu/genotype.py`` (numpy only): the port
imports nothing of the JAX package. Genotypes and pickles are identical
between the two packages (tests/test_torch_port_layers.py).

This is layer L0 of the framework: the architecture-encoding namedtuples, the
primitive vocabularies, and the two (pure numpy, host-side) genotype-parsing
algorithms that turn continuous architecture weights (alpha / beta / gamma)
into a discrete :class:`Genotype`.

Reference parity:
  * namedtuples / vocabularies: ``models/search/darts/genotypes.py:3-21``
  * outer parse ("sample strategy v3"): ``models/search/darts/model_search.py:111-182``
  * inner parse: ``models/search/darts/node_search.py:110-163``

The parse algorithms here are deliberately exact ports of the reference
semantics (pair-product scoring, non-repeat node constraint, exclusion of the
``none`` op, input-nodes-only candidate list) because genotype bit-parity is a
correctness contract: a search run on this framework and on the reference must
derive the same discrete architecture from the same weights.
"""
from __future__ import annotations

import io
import pickle
from collections import namedtuple
from typing import List, Sequence

import numpy as np

Genotype = namedtuple("Genotype", "edges steps concat")
StepGenotype = namedtuple("StepGenotype", "inner_edges inner_steps inner_concat")

# Outer-edge primitive vocabulary (reference genotypes.py:6-9).
PRIMITIVES: List[str] = ["none", "skip"]

# Inner-edge primitive vocabulary (reference genotypes.py:11-14).
STEP_EDGE_PRIMITIVES: List[str] = ["none", "skip"]

# Inner fusion-op vocabulary (reference genotypes.py:16-21).
STEP_STEP_PRIMITIVES: List[str] = ["Sum", "ScaleDotAttn", "LinearGLU", "ConcatFC"]

_NONE_IDX = PRIMITIVES.index("none")


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def parse_outer_edges(weights: np.ndarray, steps: int, num_input_nodes: int) -> list:
    """Derive the outer cell edges from softmaxed alpha weights.

    ``weights`` has shape ``(sum_i (num_input_nodes + i), len(PRIMITIVES))`` and
    must already be softmaxed. Implements the reference's "sample strategy v3"
    (model_search.py:122-158):

    * per step, candidate inputs are only the *original* input nodes
      (``range(num_input_nodes)``), never intermediate states;
    * all ordered pairs (j, k), j < k, where at least one of the two nodes has
      not been selected by a previous step, are scored by the product of each
      node's max non-``none`` weight;
    * the best pair is kept; per chosen node the argmax non-``none`` op is
      recorded. With the stock vocabulary this is always ``'skip'``.
    """
    weights = np.asarray(weights)
    gene = []
    n = num_input_nodes
    start = 0
    selected_nodes: list = []
    for i in range(steps):
        end = start + n
        W = weights[start:end].copy()

        from_list = list(range(num_input_nodes))
        node_pairs = []
        for j_index, j in enumerate(from_list):
            for k in from_list[j_index + 1:]:
                if (j not in selected_nodes) or (k not in selected_nodes):
                    W_j_max = max(W[j][t] for t in range(len(W[j])) if t != _NONE_IDX)
                    W_k_max = max(W[k][t] for t in range(len(W[k])) if t != _NONE_IDX)
                    node_pairs.append([j, k, W_j_max * W_k_max])

        selected_node_pair = sorted(node_pairs, key=lambda x: -x[2])[:1][0]
        edges = selected_node_pair[0:2]
        selected_nodes += edges
        selected_nodes = list(set(selected_nodes))

        for j in edges:
            k_best = None
            for k in range(len(W[j])):
                if k != _NONE_IDX:
                    if k_best is None or W[j][k] > W[j][k_best]:
                        k_best = k
            gene.append((PRIMITIVES[k_best], j))
        start = end
        n += 1
    return gene


def parse_inner_node(
    edge_weights: np.ndarray,
    node_weights: np.ndarray,
    node_steps: int,
    node_multiplier: int,
    num_input_nodes: int = 2,
    num_keep_edges: int = 2,
) -> StepGenotype:
    """Derive one inner fusion node's StepGenotype (node_search.py:110-163).

    ``edge_weights``: softmaxed betas, shape ``(sum_i (2 + i), 2)``.
    ``node_weights``: softmaxed gammas, shape ``(node_steps, 4)``.

    Classic DARTS parse: per inner step keep the top ``num_keep_edges`` input
    edges ranked by max non-``none`` beta (Python ``sorted`` — stable, so ties
    break toward the lower state index), each edge's op is the argmax
    non-``none`` primitive; per step the fusion op is the plain argmax gamma.
    """
    edge_weights = np.asarray(edge_weights)
    node_weights = np.asarray(node_weights)
    edge_gene = []
    node_gene = []

    none_edge_idx = STEP_EDGE_PRIMITIVES.index("none")
    n = num_input_nodes
    start = 0
    for i in range(node_steps):
        end = start + n
        W = edge_weights[start:end]
        edges = sorted(
            range(i + num_input_nodes),
            key=lambda x: -max(W[x][k] for k in range(len(W[x])) if k != none_edge_idx),
        )[:num_keep_edges]
        for j in edges:
            k_best = None
            for k in range(len(W[j])):
                if k != none_edge_idx:
                    if k_best is None or W[j][k] > W[j][k_best]:
                        k_best = k
            edge_gene.append((STEP_EDGE_PRIMITIVES[k_best], j))
        start = end
        n += 1

    for i in range(node_steps):
        W = node_weights[i]
        k_best = None
        for k in range(len(W)):
            if k_best is None or W[k] > W[k_best]:
                k_best = k
        node_gene.append(STEP_STEP_PRIMITIVES[k_best])

    concat_gene = list(
        range(num_input_nodes + node_steps - node_multiplier, node_steps + num_input_nodes)
    )
    return StepGenotype(
        inner_edges=edge_gene, inner_steps=node_gene, inner_concat=concat_gene
    )


def derive_genotype(
    alphas: np.ndarray,
    betas: Sequence[np.ndarray],
    gammas: Sequence[np.ndarray],
    steps: int,
    multiplier: int,
    num_input_nodes: int,
    node_steps: int,
    node_multiplier: int,
) -> Genotype:
    """Full genotype derivation from raw (pre-softmax) arch params.

    ``betas[i]`` / ``gammas[i]`` are the inner arch params of outer step node
    ``i``. Mirrors ``FusionNetwork.genotype`` (model_search.py:111-182).
    """
    gene_edges = parse_outer_edges(softmax(alphas), steps, num_input_nodes)
    gene_steps = [
        parse_inner_node(
            softmax(betas[i]), softmax(gammas[i]), node_steps, node_multiplier
        )
        for i in range(steps)
    ]
    gene_concat = list(
        range(num_input_nodes + steps - multiplier, steps + num_input_nodes)
    )
    return Genotype(edges=gene_edges, concat=gene_concat, steps=gene_steps)


# ---------------------------------------------------------------------------
# Reference-compatible pickle round-trip.
#
# The reference persists genotypes with plain ``pickle.dump`` of namedtuples
# defined in ``models.search.darts.genotypes`` (darts/utils.py:96-105), so the
# class path is baked into the pickle stream. To interoperate both ways we
# (a) read reference pickles by remapping that module path onto our classes,
# and (b) write pickles that advertise the reference path so the reference
# code (and any downstream tooling) can load ours.
# ---------------------------------------------------------------------------

_REF_MODULE = "models.search.darts.genotypes"


class _CompatUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name in ("Genotype", "StepGenotype") and (
            module == _REF_MODULE or module == __name__ or module.endswith("genotype")
        ):
            return {"Genotype": Genotype, "StepGenotype": StepGenotype}[name]
        return super().find_class(module, name)


def _ref_shim_classes():
    """Make a stub ``models.search.darts.genotypes`` module available so that
    plain pickling emits the reference class path. Returns
    ``(Genotype, StepGenotype, installed)`` where ``installed`` lists the
    module names this call added to ``sys.modules`` — the caller MUST remove
    them once the pickle stream is written. A *persistent* stub ``models``
    package (empty ``__path__``) would shadow the real reference package for
    any later ``import models.search...`` in the same process and break it
    with ModuleNotFoundError.

    If a real module already occupies the path (e.g. tests emulating the
    reference, or the reference itself on sys.path), its classes are used
    and nothing is installed.
    """
    import sys
    import types

    installed = []
    mod = sys.modules.get(_REF_MODULE)
    if mod is None or not hasattr(mod, "Genotype"):
        parts = _REF_MODULE.split(".")
        for i in range(1, len(parts)):
            name = ".".join(parts[:i])
            if name not in sys.modules:
                pkg = types.ModuleType(name)
                pkg.__path__ = []  # mark as package
                sys.modules[name] = pkg
                installed.append(name)
        mod = types.ModuleType(_REF_MODULE)
        RefG = namedtuple("Genotype", "edges steps concat")
        RefS = namedtuple("StepGenotype", "inner_edges inner_steps inner_concat")
        RefG.__module__ = _REF_MODULE
        RefS.__module__ = _REF_MODULE
        mod.Genotype = RefG
        mod.StepGenotype = RefS
        sys.modules[_REF_MODULE] = mod
        installed.append(_REF_MODULE)
    return mod.Genotype, mod.StepGenotype, installed


def _to_ref(genotype: Genotype, RefG, RefS):
    steps = [
        RefS(inner_edges=list(s.inner_edges), inner_steps=list(s.inner_steps),
             inner_concat=list(s.inner_concat))
        for s in genotype.steps
    ]
    return RefG(edges=list(genotype.edges), steps=steps,
                concat=list(genotype.concat))


def save_genotype(genotype: Genotype, path: str) -> None:
    """Pickle a genotype (reference-compatible stream, darts/utils.py:96-99).

    The reference-path module shim is transient: installed around the dump
    (pickle's save_global imports the class's module to verify it), removed
    right after so the real ``models`` package stays importable."""
    import sys

    RefG, RefS, installed = _ref_shim_classes()
    try:
        with open(path, "wb") as f:
            pickle.dump(_to_ref(genotype, RefG, RefS), f, protocol=2)
    finally:
        for name in installed:
            sys.modules.pop(name, None)


def load_genotype(path: str) -> Genotype:
    """Load a genotype pickled by either this framework or the reference."""
    with open(path, "rb") as f:
        return _CompatUnpickler(f).load()


def loads_genotype(data: bytes) -> Genotype:
    return _CompatUnpickler(io.BytesIO(data)).load()
