"""MM-IMDB backbones, the searchable supernet task net and the found one.

Port of ``bmnas_tpu/models/mmimdb.py`` (GPVGG, MaxOutMLP,
SearchableImageTextNet, FoundImageTextNet, MMIMDB_FROZEN_PREFIXES). Images
come in NHWC as in the reference; the VGG stack runs in NCHW on cuDNN and
hands its taps back NHWC, so the reshape layers see the reference's
layout.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bmnas_tpu_torch import genotype as G
from bmnas_tpu_torch.models.foundnet import FoundFusionNetwork, _freeze
from bmnas_tpu_torch.models.supernet import ArchParams, FusionNetwork
from bmnas_tpu_torch.ops.layers import (
    BatchNorm,
    GlobalPooling2D,
    Maxout,
    ReshapeInputLayerMMIMDB,
)

# VGG-19 feature config (torchvision): conv channel counts, 'M' = 2x2 maxpool.
VGG19_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
# Tap points by torch features-list index: 20/26/33 are ReLU outputs in
# blocks 4/4/5, 36 is the final maxpool.
VGG19_TAPS = (20, 26, 33, 36)
# Reshape-layer input channel counts (4 image taps, 2 text taps).
MMIMDB_C_INS = (512, 512, 512, 512, 64, 128)
TEXT_DIM = 300


class GPVGG(nn.Module):
    """VGG-19 feature stack with 4 intermediate taps + classifier head.
    Convolutions are named ``conv_i`` as in the reference's flax scopes."""

    def __init__(self, num_outputs: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        c_in, i = 3, 0
        for v in VGG19_CFG:
            if v != "M":
                self.add_module(f"conv_{i}",
                                nn.Conv2d(c_in, v, 3, padding=1, **kw))
                c_in, i = v, i + 1
        self.pool = GlobalPooling2D()
        self.bn4 = BatchNorm(512, **kw)
        self.classifier = nn.Linear(512, num_outputs, **kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        taps = []
        idx = conv_i = 0
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW for cuDNN
        nhwc = lambda t: t.permute(0, 2, 3, 1).contiguous()  # noqa: E731
        for v in VGG19_CFG:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
                if idx in VGG19_TAPS:
                    taps.append(nhwc(x))
                idx += 1
            else:
                x = F.relu(getattr(self, f"conv_{conv_i}")(x))
                conv_i += 1
                idx += 2  # conv module, relu module
                if idx - 1 in VGG19_TAPS:
                    taps.append(nhwc(x))
        out_1, out_2, out_3, out_4 = taps
        logits = self.classifier(self.bn4(self.pool(out_4)))
        return out_1, out_2, out_3, out_4, logits


class MaxOutMLP(nn.Module):
    """Two-stage maxout MLP over 300-d text features."""

    def __init__(self, num_outputs: int, first_hidden: int = 64,
                 in_features: int = TEXT_DIM, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.op1 = Maxout(in_features, first_hidden, 5, **kw)
        self.bn1 = BatchNorm(first_hidden, **kw)
        self.op3 = Maxout(first_hidden, first_hidden * 2, 5, **kw)
        self.bn2 = BatchNorm(first_hidden * 2, **kw)
        self.hid2val = nn.Linear(first_hidden * 2, num_outputs, **kw)
        self.dropout = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor):
        o1 = self.op1(x)
        o3 = self.op3(self.dropout(self.bn1(o1)))
        o5 = self.hid2val(self.dropout(self.bn2(o3)))
        return o1, o3, o5


# Backbone submodules the search's weight optimizer leaves out (the
# reference's central_params(): reshape layers, fusion net and classifier
# only).
MMIMDB_FROZEN_PREFIXES = ("imagenet", "textnet")


class SearchableImageTextNet(nn.Module):
    """Supernet task model: both backbones, six reshape layers (four image
    taps, two text taps), the fusion supernet and the central classifier.
    ``forward(batch, arch)`` takes the arch tensors from outside."""

    def __init__(self, C: int, L: int, steps: int, multiplier: int,
                 node_steps: int, node_multiplier: int, num_input_nodes: int,
                 num_keep_edges: int, num_outputs: int, drpt: float,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.imagenet = GPVGG(num_outputs, **kw)
        self.textnet = MaxOutMLP(num_outputs, **kw)
        for i, c_in in enumerate(MMIMDB_C_INS):
            self.add_module(f"reshape_{i}", ReshapeInputLayerMMIMDB(
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
        image_feats = self.imagenet(batch["image"])
        text_feats = self.textnet(batch["text"])
        feats = list(image_feats[:-1]) + list(text_feats[:-1])
        reshaped = [getattr(self, f"reshape_{i}")(f)
                    for i, f in enumerate(feats)]
        return self.central_classifier(self.fusion_net(reshaped, arch))


class FoundImageTextNet(nn.Module):
    """Found task model compiled from a genotype.

    Reshape layers exist only for the input indices the genotype's edges
    consume; the other slots are parameterless stand-ins whose output the
    cell never reads.
    """
    INPUT_KEYS = ("image", "text")

    def __init__(self, C: int, L: int, steps: int, multiplier: int,
                 node_steps: int, node_multiplier: int, num_input_nodes: int,
                 num_keep_edges: int, num_outputs: int, drpt: float,
                 genotype: Tuple, node_variant: str = "bmnas",
                 fused_eval: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.C, self.L = C, L
        self.genotype = genotype
        self.imagenet = GPVGG(num_outputs, **kw)
        self.textnet = MaxOutMLP(num_outputs, **kw)
        # an edge may also read an earlier step's output (index >= the
        # number of inputs), which needs no reshape layer
        self.used = tuple(sorted({idx for _, idx in genotype[0]
                                  if idx < len(MMIMDB_C_INS)}))
        for i in self.used:
            self.add_module(f"reshape_{i}", ReshapeInputLayerMMIMDB(
                MMIMDB_C_INS[i], C, L, drpt, **kw))
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
                      ) -> "FoundImageTextNet":
        return cls(genotype=_freeze(genotype), **kwargs)

    def forward(self, batch: Dict[str, torch.Tensor], arch=None
                ) -> torch.Tensor:
        """``arch`` is taken and ignored, as in the JAX ``__call__``, so the
        step functions call every task model alike."""
        image_feats = self.imagenet(batch["image"])
        text_feats = self.textnet(batch["text"])
        feats = list(image_feats[:-1]) + list(text_feats[:-1])
        reshaped = []
        for i, f in enumerate(feats):
            if i in self.used:
                reshaped.append(getattr(self, f"reshape_{i}")(f))
            else:
                reshaped.append(f.new_zeros(f.shape[0], self.L, self.C))
        return self.central_classifier(self.fusion_net(reshaped))
