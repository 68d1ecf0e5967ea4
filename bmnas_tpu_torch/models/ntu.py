"""NTU RGB+D backbones and the found task net.

Port of ``bmnas_tpu/models/ntu.py`` (normalize_uint8_clip, Visual,
_ntu_features, FoundSkeletonImageNet, NTU_C_INS). Clips are
``(B, T, H, W, 3)``, uint8 from the loader and normalized on the device;
skeletons are ``(B, T, V=25, M=2, 3)``. The eight fusion inputs are the
inflated ResNet-50's stages fm2, fm3, fm4 and its pooled vector, then HCN's
out5, out6, out7 and out8. Submodules carry the flax scope names
(``rgbnet.cnn.layer1_0.conv1``, ``skenet.conv1``, ``reshape_i``,
``fusion_net``, ``central_classifier``), so ``utils/convert.py`` maps a JAX
checkpoint one to one.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from bmnas_tpu_torch import genotype as G
from bmnas_tpu_torch.models.foundnet import FoundFusionNetwork, _freeze
from bmnas_tpu_torch.models.hcn import HCN
from bmnas_tpu_torch.models.inflated_resnet import InflatedResNet50
from bmnas_tpu_torch.ops.layers import ReshapeInputLayer

NTU_C_INS = (512, 1024, 2048, 2048, 128, 256, 1024, 512)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_uint8_clip(x: torch.Tensor,
                         mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """uint8 ``(B, T, H, W, 3)`` -> fp32 ImageNet-normalized: /255, then
    (x - mean) / std, in fp32, on the clip's device. Float clips (already
    normalized on the host) pass unchanged.

    ``mask`` (B,) marks the valid rows: a padded row is zero bytes, which
    would normalize to -mean/std; times the mask it stays zero, as a padded
    row of a host-normalized batch is."""
    if x.dtype != torch.uint8:
        return x
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=x.device)
    x = (x.float() / 255.0 - mean) / std
    if mask is not None:
        x = x * mask.reshape((-1,) + (1,) * (x.dim() - 1))
    return x


class Visual(nn.Module):
    """Inflated ResNet-50, the mean over (T, H, W) of its last stage, and a
    classifier. ``forward(x) -> (fm1, fm2, fm3, fm4, pooled, logits)``."""

    def __init__(self, num_outputs: int, device=None, dtype=None):
        super().__init__()
        self.cnn = InflatedResNet50(device=device, dtype=dtype)
        self.classifier = nn.Linear(2048, num_outputs, device=device,
                                    dtype=dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = normalize_uint8_clip(x).to(self.classifier.weight.dtype)
        fm1, fm2, fm3, fm4 = self.cnn(x)
        pooled = fm4.mean(dim=(1, 2, 3))
        return fm1, fm2, fm3, fm4, pooled, self.classifier(pooled)


def _ntu_features(rgbnet_out: Sequence[torch.Tensor],
                  ske_out: Tuple[List[torch.Tensor], torch.Tensor]
                  ) -> List[torch.Tensor]:
    """fm2, fm3, fm4, pooled; then out5, out6, out7, out8."""
    return list(rgbnet_out[-5:-1]) + list(ske_out[0][-4:])


class FoundSkeletonImageNet(nn.Module):
    """Found task model compiled from a genotype.

    Reshape layers exist only for the input indices the genotype's edges
    consume; the other slots are zeros with no parameters, which the cell
    never reads.
    """
    INPUT_KEYS = ("image", "skeleton", "mask")

    def __init__(self, C: int, L: int, steps: int, multiplier: int,
                 node_steps: int, node_multiplier: int, num_input_nodes: int,
                 num_keep_edges: int, num_outputs: int, drpt: float,
                 genotype: Tuple, node_variant: str = "bmnas",
                 fused_eval: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.C, self.L = C, L
        self.genotype = genotype
        self.rgbnet = Visual(num_outputs, **kw)
        self.skenet = HCN(num_outputs, drpt, **kw)
        # an edge may also read an earlier step's output (index >= the
        # number of inputs), which needs no reshape layer
        self.used = tuple(sorted({idx for _, idx in genotype[0]
                                  if idx < len(NTU_C_INS)}))
        for i in self.used:
            self.add_module(f"reshape_{i}", ReshapeInputLayer(
                NTU_C_INS[i], C, L, drpt, **kw))
        self.fusion_net = FoundFusionNetwork(
            steps=steps, multiplier=multiplier,
            num_input_nodes=num_input_nodes, num_keep_edges=num_keep_edges,
            node_steps=node_steps, node_multiplier=node_multiplier, C=C, L=L,
            drpt=drpt, genotype=genotype, node_variant=node_variant,
            fused_eval=fused_eval, **kw)
        self.central_classifier = nn.Linear(L * multiplier * C, num_outputs,
                                            **kw)

    @classmethod
    def from_genotype(cls, genotype: G.Genotype, **kwargs
                      ) -> "FoundSkeletonImageNet":
        return cls(genotype=_freeze(genotype), **kwargs)

    def forward(self, batch: Dict[str, torch.Tensor], arch=None
                ) -> torch.Tensor:
        """``arch`` is taken and ignored, as in the JAX ``__call__``."""
        image = normalize_uint8_clip(batch["image"], batch.get("mask"))
        feats = _ntu_features(self.rgbnet(image),
                              self.skenet(batch["skeleton"]))
        reshaped = []
        for i, f in enumerate(feats):
            if i in self.used:
                reshaped.append(getattr(self, f"reshape_{i}")(f))
            else:
                reshaped.append(f.new_zeros(f.shape[0], self.L, self.C))
        return self.central_classifier(self.fusion_net(reshaped))
