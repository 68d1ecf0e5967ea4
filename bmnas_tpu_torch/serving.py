"""Found-net inference serving.

Port of ``bmnas_tpu/serving.py`` (FoundNetServer, load_server): a found
task net in eval mode on one device, fp32 or bf16 weights and activations
(logits returned in fp32; in bf16 the BatchNorms keep fp32 weights and
statistics), fixed-size batches with a ``mask``, valid rows
trimmed on return. Integer inputs (NTU's uint8 clips, Ego's uint8 RGB and
depth clips) are uploaded as they are and normalized by the model on the
device. Every FoundNodeCell
folds its BatchNorms once, when the server is built; on CUDA each cell
then runs the found-cell kernel.
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from bmnas_tpu_torch.device import resolve_device
from bmnas_tpu_torch.models.foundnet import FoundNodeCell


class FoundNetServer:
    """Wraps a found task net + trained weights for batched inference."""

    def __init__(self, model: nn.Module,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 dtype: torch.dtype = torch.float32, fused: bool = False,
                 device=None):
        self.device = resolve_device(device)
        self.dtype = dtype
        if state_dict is not None:
            model.load_state_dict(state_dict)
        for m in model.modules():
            if isinstance(m, FoundNodeCell) and fused:
                m._check_hostable()
                m.fused_eval = True
        # eval BatchNorm takes bf16 activations with fp32 weights and
        # statistics, and then rounds nothing but its output; cast to bf16
        # they also send it, on CUDA, to a slower elementwise kernel, the
        # longest of a bf16 NTU request (chip_smoke.py phase 10's trace)
        bn_state = {} if dtype == torch.float32 else {
            name: {k: v.clone() for k, v in m.state_dict().items()}
            for name, m in model.named_modules()
            if isinstance(m, nn.modules.batchnorm._BatchNorm)}
        model.to(device=self.device, dtype=dtype)
        for name, state in bn_state.items():
            model.get_submodule(name).float().load_state_dict(state)
        self.model = model.eval()
        for m in self.model.modules():
            if isinstance(m, FoundNodeCell) and m._folded is None and (
                    m.fused_eval or self.device.type == "cuda"):
                m.fold()
        self.input_keys = getattr(model, "INPUT_KEYS", None)

    def _inputs(self, batch: Mapping[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
        """The model's inputs on the device: floating arrays in the
        server's dtype, integer ones (the uint8 clips of an NTU or Ego
        batch, which the model normalizes) as they are."""
        keys = self.input_keys or [k for k in batch
                                   if k not in ("label", "mask")]
        out = {}
        for k in keys:
            t = torch.as_tensor(batch[k])
            out[k] = t.to(self.device, self.dtype if t.is_floating_point()
                          else t.dtype, non_blocking=True)
        return out

    @torch.inference_mode()
    def predict(self, batch: Mapping[str, np.ndarray]) -> np.ndarray:
        """Run one batch; returns host fp32 logits for the valid rows."""
        logits = self.model(self._inputs(batch)).float().cpu().numpy()
        if "mask" in batch:
            return logits[:int(np.asarray(batch["mask"]).sum())]
        return logits

    def predict_stream(self, batches: Iterable[Mapping[str, np.ndarray]]
                       ) -> np.ndarray:
        """Run an iterator of batches; returns the concatenated logits."""
        return np.concatenate([self.predict(b) for b in batches], axis=0)


def load_server(snapshot_path: str, model: nn.Module,
                dtype: torch.dtype = torch.float32, fused: bool = False,
                device=None) -> FoundNetServer:
    """A server from a ``best_model.pt`` snapshot (utils.checkpoint)."""
    from bmnas_tpu_torch.utils.checkpoint import load_model
    return FoundNetServer(model, load_model(snapshot_path), dtype=dtype,
                          fused=fused, device=device)
