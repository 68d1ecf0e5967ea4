"""EgoGesture task net: the found net over two 3D ResNeXt-101 backbones.

Port of ``bmnas_tpu/models/ego.py`` (EGO_C_INS, EGO_FROZEN_PREFIXES,
normalize_uint8_ego, FoundRGBDepthNet). Clips are ``(B, T, S, S, 3)`` RGB
and ``(B, T, S, S, 1)`` depth, uint8 from the loader and normalized on the
device. The eight fusion inputs are the RGB net's x2, x3, x4 and pooled
vector, then the depth net's. Submodules carry the flax scope names
(``rgb_net.layer1_0.conv2``, ``depth_net.fc``, ``reshape_i``,
``fusion_net``, ``central_classifier``), so ``utils/convert.py`` maps a JAX
checkpoint one to one; each backbone keeps its ``fc``, whose logits the
net does not read.

The backbones always run in eval mode: their BatchNorms use the running
statistics whatever mode the net is in, as in the JAX package and the
reference. The searchable supernet comes with the Ego search (ROADMAP.md
Queue 1 item 5b).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from bmnas_tpu_torch import genotype as G
from bmnas_tpu_torch.models.foundnet import FoundFusionNetwork, _freeze
from bmnas_tpu_torch.models.resnext import get_depth_model, get_rgb_model
from bmnas_tpu_torch.ops.layers import ReshapeInputLayer

EGO_C_INS = (512, 1024, 2048, 2048, 512, 1024, 2048, 2048)
EGO_FROZEN_PREFIXES = ("rgb_net", "depth_net")

# the RGB mean of the reference's transforms (data/ego.EGO_MEAN)
EGO_MEAN = (114.7748, 107.7354, 99.475)


def normalize_uint8_ego(rgb: torch.Tensor, depth: torch.Tensor,
                        mask: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 clips -> fp32 in the reference's 0-255 space: the RGB mean
    subtracted, depth as it is (the reference's Normalize zips 3 means
    against 4 channels). Float clips (normalized on the host) pass
    unchanged.

    ``mask`` (B,) marks the valid rows: a padded row is zero bytes, which
    would become -mean; times the mask it stays zero, as a padded row of a
    host-normalized batch is."""
    def rows(x):
        return x if mask is None else x * mask.reshape(
            (-1,) + (1,) * (x.dim() - 1))
    if rgb.dtype == torch.uint8:
        mean = torch.tensor(EGO_MEAN, dtype=torch.float32, device=rgb.device)
        rgb = rows(rgb.float() - mean)
    if depth.dtype == torch.uint8:
        depth = rows(depth.float())
    return rgb, depth


class FoundRGBDepthNet(nn.Module):
    """Found task model compiled from a genotype.

    Reshape layers exist only for the input indices the genotype's edges
    consume; the other slots are zeros with no parameters, which the cells
    never read.
    """
    INPUT_KEYS = ("rgb", "depth", "mask")

    def __init__(self, C: int, L: int, steps: int, multiplier: int,
                 node_steps: int, node_multiplier: int, num_input_nodes: int,
                 num_keep_edges: int, num_outputs: int, drpt: float,
                 genotype: Tuple, node_variant: str = "bmnas",
                 fused_eval: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.C, self.L = C, L
        self.genotype = genotype
        # first, so that a cell the kernel cannot host is refused before the
        # backbones' weights are allocated
        self.fusion_net = FoundFusionNetwork(
            steps=steps, multiplier=multiplier,
            num_input_nodes=num_input_nodes, num_keep_edges=num_keep_edges,
            node_steps=node_steps, node_multiplier=node_multiplier, C=C, L=L,
            drpt=drpt, genotype=genotype, node_variant=node_variant,
            fused_eval=fused_eval, **kw)
        self.rgb_net = get_rgb_model(num_outputs, **kw)
        self.depth_net = get_depth_model(num_outputs, **kw)
        # an edge may also read an earlier step's output (index >= the
        # number of inputs), which needs no reshape layer
        self.used = tuple(sorted({idx for _, idx in genotype[0]
                                  if idx < len(EGO_C_INS)}))
        for i in self.used:
            self.add_module(f"reshape_{i}", ReshapeInputLayer(
                EGO_C_INS[i], C, L, drpt, **kw))
        self.central_classifier = nn.Linear(L * multiplier * C, num_outputs,
                                            **kw)

    @classmethod
    def from_genotype(cls, genotype: G.Genotype, **kwargs
                      ) -> "FoundRGBDepthNet":
        return cls(genotype=_freeze(genotype), **kwargs)

    def train(self, mode: bool = True) -> "FoundRGBDepthNet":
        super().train(mode)
        self.rgb_net.eval()
        self.depth_net.eval()
        return self

    def forward(self, batch: Dict[str, torch.Tensor], arch=None
                ) -> torch.Tensor:
        """``arch`` is taken and ignored, as in the JAX ``__call__``."""
        rgb, depth = normalize_uint8_ego(batch["rgb"], batch["depth"],
                                         batch.get("mask"))
        feats = list(self.rgb_net(rgb)[:-1]) + list(
            self.depth_net(depth)[:-1])
        reshaped = []
        for i, f in enumerate(feats):
            if i in self.used:
                reshaped.append(getattr(self, f"reshape_{i}")(f))
            else:
                reshaped.append(f.new_zeros(f.shape[0], self.L, self.C))
        return self.central_classifier(self.fusion_net(reshaped))
