"""Carry weights from the JAX package's checkpoints into the port.

``state_dict_from_jax(params, batch_stats)`` takes the nested dicts of
numpy arrays that ``bmnas_tpu.utils.checkpoint.load_model`` returns (flax
``params`` / ``batch_stats`` trees) and returns the port's ``state_dict``.
It imports neither flax nor JAX.

The port names its submodules after the flax scopes, so the mapping is
mechanical:

* a scope path ``a/b/c`` becomes the key prefix ``a.b.c``;
* ``kernel`` -> ``weight``: a 2-D conv's HWIO becomes OIHW, a 3-D conv's
  (kT, kH, kW, I, O) becomes ``Conv3d.weight``'s (O, I, kT, kH, kW) (a
  grouped one's I is the inputs a group, in both frameworks, and its
  output channels are group-major in both), a dense layer's (in, out)
  becomes ``Linear.weight``'s (out, in);
* ``scale`` -> ``weight`` (BatchNorm and LayerNorm2D; LayerNorm2D's (L, C)
  keeps its shape), ``bias`` -> ``bias``;
* ``batch_stats`` ``mean``/``var`` -> ``running_mean``/``running_var``,
  plus ``num_batches_tracked`` = 0;
* the flax BatchNorm inside the JAX package's BatchNorm wrapper is always
  scoped ``BatchNorm_0``; that inner scope is dropped, since the port's
  BatchNorm is the wrapper itself
  (``reshape_0/BatchNorm_0/BatchNorm_0/scale`` ->
  ``reshape_0.BatchNorm_0.weight``, ``imagenet/bn4/BatchNorm_0/scale`` ->
  ``imagenet.bn4.weight``).

Repeated inner ops keep flax's per-class counters (``LinearGLU_0``,
``LinearGLU_1``) because the port counts the same way; inputs the genotype
does not reference have no parameters on either side. The supernet's mixed
ops map the same way (``fusion_net/cell/step_node_0/NodeMixedOp_0/
LinearGLU_0/Dense_0/kernel`` -> ``fusion_net.cell.step_node_0.
NodeMixedOp_0.LinearGLU_0.Dense_0.weight``).

``arch_from_jax(arch)`` turns the JAX package's ``alphas``/``betas``/
``gammas`` arrays into the port's arch tensors.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_BN_INNER = "BatchNorm_0"
# flax kernel layout -> torch weight layout, by the kernel's rank
_KERNEL_AXES = {
    2: lambda a: a.T,                            # (in, out) -> (out, in)
    4: lambda a: a.transpose(3, 2, 0, 1),        # HWIO -> OIHW
    5: lambda a: a.transpose(4, 3, 0, 1, 2),     # THWIO -> OITHW
}


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _key(scope: Tuple[str, ...], leaf: str, bn: bool) -> str:
    if bn:
        if not scope or scope[-1] != _BN_INNER:
            raise KeyError(f"BatchNorm leaf outside a {_BN_INNER} scope: "
                           f"{'/'.join(scope + (leaf,))}")
        scope = scope[:-1]
    return ".".join(scope + (leaf,))


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def state_dict_from_jax(params: Mapping[str, Any],
                        batch_stats: Mapping[str, Any] = None
                        ) -> "OrderedDict[str, torch.Tensor]":
    """The port's state_dict from JAX ``params`` and ``batch_stats``."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for path, a in _leaves(params):
        scope, leaf = path[:-1], path[-1]
        bn = bool(scope) and scope[-1] == _BN_INNER
        if leaf == "kernel":
            if a.ndim not in _KERNEL_AXES:
                raise KeyError(f"no torch layout for the {a.ndim}-D kernel "
                               f"{'/'.join(path)}")
            a = _KERNEL_AXES[a.ndim](a)
            sd[_key(scope, "weight", False)] = _tensor(a)
        elif leaf == "scale":
            sd[_key(scope, "weight", bn)] = _tensor(a)
        elif leaf == "bias":
            sd[_key(scope, "bias", bn)] = _tensor(a)
        else:
            raise KeyError(f"unknown parameter {'/'.join(path)}")
    for path, a in _leaves(batch_stats or {}):
        scope, leaf = path[:-1], path[-1]
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise KeyError(f"unknown batch stat {'/'.join(path)}")
        sd[_key(scope, names[leaf], True)] = _tensor(a)
        sd[_key(scope, "num_batches_tracked", True)] = torch.tensor(
            0, dtype=torch.long)
    return sd


def arch_from_jax(arch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's arch tensors (fp32 leaves on the CPU that require grad)
    from the JAX package's ``alphas``/``betas``/``gammas`` arrays."""
    return {k: torch.tensor(np.asarray(arch[k]), dtype=torch.float32)
            .requires_grad_()
            for k in ("alphas", "betas", "gammas")}
