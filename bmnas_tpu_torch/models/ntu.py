"""NTU RGB+D backbones and task nets: the searchable supernet, the found
net and the whole-net ablation baselines.

Port of ``bmnas_tpu/models/ntu.py`` (normalize_uint8_clip, Visual,
_ntu_features, SearchableSkeletonImageNet, FoundSkeletonImageNet,
_AblationClassifier, NTUAblationNet, NTU_TASK_VARIANTS, NTU_C_INS and the
frozen prefixes). Clips are
``(B, T, H, W, 3)``, uint8 from the loader and normalized on the device;
skeletons are ``(B, T, V=25, M=2, 3)``. The eight fusion inputs are the
inflated ResNet-50's stages fm2, fm3, fm4 and its pooled vector, then HCN's
out5, out6, out7 and out8. Submodules carry the flax scope names
(``rgbnet.cnn.layer1_0.conv1``, ``skenet.conv1``, ``reshape_i``,
``fusion_net``, ``central_classifier``), so ``utils/convert.py`` maps a JAX
checkpoint one to one.

The search's weight optimizer covers the fusion net and the classifier
only: unlike MM-IMDB's, NTU's reference leaves the reshape layers out too,
so :data:`NTU_SEARCH_FROZEN_PREFIXES` holds every ``reshape_i`` beside the
backbones. Found retraining trains the whole net. ``remat`` reruns each
bottleneck of the 3D ResNet in the backward (``models/inflated_resnet.py``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bmnas_tpu_torch import genotype as G
from bmnas_tpu_torch.models.foundnet import FoundFusionNetwork, _freeze
from bmnas_tpu_torch.models.hcn import HCN
from bmnas_tpu_torch.models.inflated_resnet import InflatedResNet50
from bmnas_tpu_torch.models.supernet import ArchParams, FusionNetwork
from bmnas_tpu_torch.ops.fusion_ops import ScaledDotAttn
from bmnas_tpu_torch.ops.layers import BatchNorm, ReshapeInputLayer

NTU_C_INS = (512, 1024, 2048, 2048, 128, 256, 1024, 512)
# the search's weight step leaves these top-level submodules out
NTU_SEARCH_FROZEN_PREFIXES = ("rgbnet", "skenet") + tuple(
    f"reshape_{i}" for i in range(len(NTU_C_INS)))
# found retraining trains every parameter
NTU_EVAL_FROZEN_PREFIXES = ()
NTU_TASK_VARIANTS = ("bmnas", "simple_concat", "ensemble_concat", "ensemble",
                     "simple_concat_attn")

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

    def __init__(self, num_outputs: int, remat: bool = False, device=None,
                 dtype=None):
        super().__init__()
        self.cnn = InflatedResNet50(remat=remat, device=device, dtype=dtype)
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


def _backbones(net: nn.Module, batch: Dict[str, torch.Tensor]):
    """Both backbones' outputs on a batch, the clip normalized (its padded
    rows kept zero)."""
    image = normalize_uint8_clip(batch["image"], batch.get("mask"))
    return net.rgbnet(image), net.skenet(batch["skeleton"])


class SearchableSkeletonImageNet(nn.Module):
    """Supernet task model: both backbones, eight reshape layers, the
    fusion supernet and the central classifier. ``forward(batch, arch)``
    takes the arch tensors from outside."""
    INPUT_KEYS = ("image", "skeleton", "mask")

    def __init__(self, C: int, L: int, steps: int, multiplier: int,
                 node_steps: int, node_multiplier: int, num_input_nodes: int,
                 num_keep_edges: int, num_outputs: int, drpt: float,
                 remat: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.rgbnet = Visual(num_outputs, remat=remat, **kw)
        self.skenet = HCN(num_outputs, drpt, **kw)
        for i, c_in in enumerate(NTU_C_INS):
            self.add_module(f"reshape_{i}", ReshapeInputLayer(
                c_in, C, L, drpt, **kw))
        self.fusion_net = FusionNetwork(
            steps=steps, multiplier=multiplier,
            num_input_nodes=num_input_nodes, num_keep_edges=num_keep_edges,
            node_steps=node_steps, node_multiplier=node_multiplier, C=C, L=L,
            drpt=drpt, **kw)
        self.central_classifier = nn.Linear(L * multiplier * C, num_outputs,
                                            **kw)

    def forward(self, batch: Dict[str, torch.Tensor], arch: ArchParams
                ) -> torch.Tensor:
        feats = _ntu_features(*_backbones(self, batch))
        reshaped = [getattr(self, f"reshape_{i}")(f)
                    for i, f in enumerate(feats)]
        return self.central_classifier(self.fusion_net(reshaped, arch))


class _AblationClassifier(nn.Module):
    """Linear(in -> C) -> ReLU -> BatchNorm -> Linear(C -> num_outputs)."""

    def __init__(self, in_features: int, C: int, num_outputs: int,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.Dense_0 = nn.Linear(in_features, C, **kw)
        self.BatchNorm_0 = BatchNorm(C, **kw)
        self.Dense_1 = nn.Linear(C, num_outputs, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(self.BatchNorm_0(F.relu(self.Dense_0(x))))


# variant -> the reshaped features its head reads (indices into the eight
# fusion inputs, then the two backbones' logits at 8 and 9)
_ABLATION_PICKS = {
    "simple_concat": (3, 7),
    "ensemble_concat": (2, 3, 7, 8, 9),
    "ensemble": (8, 9),
    "simple_concat_attn": (3, 7),
}


class NTUAblationNet(nn.Module):
    """The reference's whole-net NTU ablation baselines, one module with a
    ``variant``:

    * ``simple_concat``: the reshaped fm4-pooled vector (v3) and HCN's out8
      (s3), concatenated, into an MLP head;
    * ``ensemble_concat``: fm4 (v2), v3, s3 and both backbones' reshaped
      logits;
    * ``ensemble``: both backbones' reshaped logits only;
    * ``simple_concat_attn``: cross attention v3 -> s3 and s3 -> v3
      (``attn1``, ``attn2``), concatenated.

    A reshape layer is built (and run) for every input, the two logits
    included in the ensemble variants, as in the JAX package, whose
    parameter tree this one maps onto one to one.
    ``forward(batch, arch)`` ignores ``arch``.
    """
    INPUT_KEYS = ("image", "skeleton", "mask")

    def __init__(self, C: int, L: int, num_outputs: int, drpt: float,
                 variant: str = "simple_concat", remat: bool = False,
                 device=None, dtype=None):
        super().__init__()
        if variant not in _ABLATION_PICKS:
            raise ValueError(f"unknown NTU task variant {variant!r}")
        kw = dict(device=device, dtype=dtype)
        self.variant = variant
        self.rgbnet = Visual(num_outputs, remat=remat, **kw)
        self.skenet = HCN(num_outputs, drpt, **kw)
        c_ins = NTU_C_INS + ((num_outputs, num_outputs)
                             if variant.startswith("ensemble") else ())
        for i, c_in in enumerate(c_ins):
            self.add_module(f"reshape_{i}", ReshapeInputLayer(
                c_in, C, L, drpt, **kw))
        if variant == "simple_concat_attn":
            self.attn1 = ScaledDotAttn(C, L, **kw)
            self.attn2 = ScaledDotAttn(C, L, **kw)
        self.central_classifier = _AblationClassifier(
            C * L * len(_ABLATION_PICKS[variant]), C, num_outputs, **kw)

    def forward(self, batch: Dict[str, torch.Tensor], arch=None
                ) -> torch.Tensor:
        rgb_out, ske_out = _backbones(self, batch)
        feats = _ntu_features(rgb_out, ske_out)
        if self.variant.startswith("ensemble"):
            feats = feats + [rgb_out[-1], ske_out[1]]  # unimodal logits
        reshaped = [getattr(self, f"reshape_{i}")(f)
                    for i, f in enumerate(feats)]
        picked = [reshaped[i] for i in _ABLATION_PICKS[self.variant]]
        if self.variant == "simple_concat_attn":
            v3, s3 = picked
            picked = [self.attn1(v3, s3), self.attn2(s3, v3)]
        out = torch.cat(picked, dim=-1)
        return self.central_classifier(out.reshape(out.shape[0], -1))


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
                 fused_eval: bool = False, remat: bool = False, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.C, self.L = C, L
        self.genotype = genotype
        self.rgbnet = Visual(num_outputs, remat=remat, **kw)
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
        feats = _ntu_features(*_backbones(self, batch))
        reshaped = []
        for i, f in enumerate(feats):
            if i in self.used:
                reshaped.append(getattr(self, f"reshape_{i}")(f))
            else:
                reshaped.append(f.new_zeros(f.shape[0], self.L, self.C))
        return self.central_classifier(self.fusion_net(reshaped))
