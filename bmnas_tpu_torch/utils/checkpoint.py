"""Model snapshots and the full-resume checkpoint, as ``torch.save``d files.

A snapshot is a state_dict at ``<exp>/best/best_model.pt`` (or
``best_test_model.pt``), the original BM-NAS format (the JAX package writes
msgpack at the same path; ``utils/convert.py`` carries those across). A
search snapshot also holds the three arch tensors, under the keys
``arch.alphas``, ``arch.betas`` and ``arch.gammas`` beside the model's own
keys (no model of the port has a submodule named ``arch``).

The full-resume checkpoint (``save_state`` / ``restore_state``,
``<exp>/checkpoint.pt``, written every epoch) holds what the JAX package's
``checkpoint.msgpack`` holds, in one dict: the model's state_dict, both
optimizers' state_dicts (the arch optimizer in search only), the arch
tensors, the torch RNG states (the CPU one, and every CUDA device's when the
model is on CUDA: JAX carries its dropout key in the train state, so a
resumed run draws the dropout masks an uninterrupted one would), and the
loop's ``extra`` (epoch, scheduler state, best metrics and epochs).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn

ARCH_PREFIX = "arch."


def _save(obj: Any, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_model(path: str, model: Union[nn.Module, Dict[str, torch.Tensor]],
               arch: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    for k, v in (arch or {}).items():
        sd[ARCH_PREFIX + k] = v.detach().cpu()
    _save(sd, path)


def load_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor],
                                        Optional[Dict[str, torch.Tensor]]]:
    """(state_dict, arch tensors or None) of a snapshot."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    arch = {k[len(ARCH_PREFIX):]: sd.pop(k) for k in list(sd)
            if k.startswith(ARCH_PREFIX)}
    return sd, arch or None


def load_model(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a snapshot (arch tensors left out)."""
    return load_checkpoint(path)[0]


def _on_cuda(model: nn.Module) -> bool:
    return any(p.is_cuda for p in model.parameters())


def save_state(path: str, state, extra: Optional[Dict[str, Any]] = None
               ) -> None:
    """Full-resume checkpoint of a ``search.bilevel.TrainState``; ``extra``
    carries the loop's host-side values."""
    opt = lambda o: None if o is None else o.state_dict()  # noqa: E731
    _save({
        "model": state.model.state_dict(),
        "opt_w": opt(state.opt_w),
        "opt_arch": opt(state.opt_arch),
        "arch": (None if state.arch is None else
                 {k: v.detach() for k, v in state.arch.items()}),
        "rng_cpu": torch.get_rng_state(),
        "rng_cuda": (torch.cuda.get_rng_state_all()
                     if _on_cuda(state.model) else None),
        "extra": dict(extra or {}),
    }, path)


def restore_state(path: str, state) -> Dict[str, Any]:
    """Restore a ``save_state`` checkpoint into a freshly built TrainState
    of the same structure, in place; returns ``extra``."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    if (ck["arch"] is None) != (state.arch is None):
        kind = "found" if ck["arch"] is None else "search"
        raise ValueError(f"{path}: a {kind} checkpoint does not fit this run")
    state.model.load_state_dict(ck["model"])
    if state.opt_w is not None:
        state.opt_w.load_state_dict(ck["opt_w"])
    if state.arch is not None:
        with torch.no_grad():
            for k, v in ck["arch"].items():
                state.arch[k].copy_(v)
        state.opt_arch.load_state_dict(ck["opt_arch"])
    torch.set_rng_state(ck["rng_cpu"])
    if ck["rng_cuda"] is not None and _on_cuda(state.model):
        torch.cuda.set_rng_state_all(ck["rng_cuda"])
    return ck["extra"]
