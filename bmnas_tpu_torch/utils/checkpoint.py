"""Model snapshots: a ``torch.save``d state_dict at ``<exp>/best/best_model.pt``,
the original BM-NAS format (the JAX package writes msgpack at the same
path; ``utils/convert.py`` carries those across).

A search snapshot also holds the three arch tensors, under the keys
``arch.alphas``, ``arch.betas`` and ``arch.gammas`` beside the model's own
keys (no model of the port has a submodule named ``arch``).
"""
from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn as nn

ARCH_PREFIX = "arch."


def save_model(path: str, model: Union[nn.Module, Dict[str, torch.Tensor]],
               arch: Optional[Mapping[str, torch.Tensor]] = None) -> None:
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    for k, v in (arch or {}).items():
        sd[ARCH_PREFIX + k] = v.detach().cpu()
    tmp = path + ".tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)


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
