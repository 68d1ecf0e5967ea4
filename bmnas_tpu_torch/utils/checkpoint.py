"""Model snapshots: a ``torch.save``d state_dict at ``<exp>/best/best_model.pt``,
the original BM-NAS format (the JAX package writes msgpack at the same
path; ``utils/convert.py`` carries those across)."""
from __future__ import annotations

import os
from typing import Dict, Union

import torch
import torch.nn as nn


def save_model(path: str, model: Union[nn.Module, Dict[str, torch.Tensor]]
               ) -> None:
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    sd = {k: v.detach().cpu() for k, v in sd.items()}
    tmp = path + ".tmp"
    torch.save(sd, tmp)
    os.replace(tmp, path)


def load_model(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location="cpu", weights_only=True)
