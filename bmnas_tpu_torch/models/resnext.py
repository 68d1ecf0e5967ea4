"""3D ResNeXt-101 (the EgoGesture RGB and depth backbones).

Port of ``bmnas_tpu/models/resnext.py`` (ResNeXtBottleneck, ResNeXt3D,
get_rgb_model, get_depth_model): a ``(stem_kernel_t, 7,
7)`` stem of stride (1, 2, 2), a 3x3x3 max pool of stride 2, then four
stages of bottlenecks (1x1x1, a 3x3x3 convolution in ``cardinality``
groups, 1x1x1; expansion 2; a stage's first block strided by 2 in T, H and
W after the first stage), the map tapped after the second, third and
fourth stages and pooled over (T, H, W) after the fourth. The stems:

* RGB: 3 channels, (3, 7, 7) padded (1, 3, 3);
* depth: 1 channel, (7, 7, 7) padded (3, 3, 3).

Layout: clips come in channels-last ``(B, T, H, W, C)`` and the taps go out
the same way, as in the JAX package; in between the convolutions run
channels-first on cuDNN, as in ``models/inflated_resnet.py``. A grouped
convolution is ``nn.Conv3d(groups=cardinality)``, whose output channels are
group-major as flax's ``feature_group_count`` ones are, so its weight
``(F, F / cardinality, 3, 3, 3)`` is the flax kernel transposed
(``utils/convert.py``). The JAX package's ``dense_grouped`` option (the
same kernel run as a block-diagonal dense convolution, for the TPU's
matrix unit) has no counterpart: its parameters load into the grouped
convolution unchanged.

Precision: the residual stream, the sum that each bottleneck adds its
branch to, stays fp32 whatever the parameters' dtype. In a net cast to
bf16 for serving, each block's branch (its convolutions and BatchNorms)
runs in bf16 from a bf16 copy of the stream and its output is added to the
stream in fp32, so that no block rounds the stream itself. Through the
66 blocks of the Ego net's two ResNeXt-101s, a stream rounded to bf16 at
every add moved the served logits by more than twice the distance that
rounding the weights and the input does (``chip_smoke.py`` phase 12's bf16
rule); an fp32 stream stays within it. The taps come back in the
parameters' dtype, as the inflated ResNet's do (the port's bf16 server
keeps the fusion path in bf16; the JAX package casts its taps to fp32).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from bmnas_tpu_torch.ops.layers import ChannelsFirstBatchNorm


class ResNeXtBottleneck(nn.Module):
    """1x1x1 -> 3x3x3 in ``cardinality`` groups (stride ``stride`` on every
    axis, padding 1) -> 1x1x1 to ``planes * 2``, each with BatchNorm, and a
    strided 1x1x1 projection of the residual where the shape changes.
    Channels-first ``(B, C, T, H, W)``."""

    expansion = 2

    def __init__(self, inplanes: int, planes: int, cardinality: int = 32,
                 stride: int = 1, downsample: bool = False, device=None,
                 dtype=None):
        super().__init__()
        self.planes = planes
        self.cardinality = cardinality
        self.stride = stride
        self.downsample = downsample
        mid = cardinality * (planes // 32)
        kw = dict(bias=False, device=device, dtype=dtype)
        bn = dict(device=device, dtype=dtype)
        self.conv1 = nn.Conv3d(inplanes, mid, 1, **kw)
        self.bn1 = ChannelsFirstBatchNorm(mid, **bn)
        self.conv2 = nn.Conv3d(mid, mid, 3, stride=stride, padding=1,
                               groups=cardinality, **kw)
        self.bn2 = ChannelsFirstBatchNorm(mid, **bn)
        self.conv3 = nn.Conv3d(mid, planes * self.expansion, 1, **kw)
        self.bn3 = ChannelsFirstBatchNorm(planes * self.expansion, **bn)
        if downsample:
            self.downsample_conv = nn.Conv3d(
                inplanes, planes * self.expansion, 1, stride=stride, **kw)
            self.downsample_bn = ChannelsFirstBatchNorm(
                planes * self.expansion, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``x``: the residual stream; returns it, fp32 (module doc)."""
        xb = x.to(self.conv1.weight.dtype)
        out = F.relu(self.bn1(self.conv1(xb)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = (self.downsample_bn(self.downsample_conv(xb))
                    if self.downsample else x)
        return F.relu(residual.float() + out)


class ResNeXt3D(nn.Module):
    """ResNeXt-101 at the defaults: ``layers`` (3, 4, 23, 3), ``planes``
    (128, 256, 512, 1024). ``forward(x)`` takes ``(B, T, H, W,
    in_channels)`` and returns ``(x2, x3, x4, pooled, logits)``: the second,
    third and fourth stages' maps channels-last (512, 1024 and 2048
    channels at the defaults), the fourth's mean over (T, H, W) and ``fc``
    of it."""

    def __init__(self, num_outputs: int,
                 layers: Tuple[int, ...] = (3, 4, 23, 3),
                 planes: Tuple[int, ...] = (128, 256, 512, 1024),
                 cardinality: int = 32, in_channels: int = 3,
                 stem_kernel_t: int = 3, device=None, dtype=None):
        super().__init__()
        self.num_outputs = num_outputs
        self.layers = tuple(layers)
        self.planes = tuple(planes)
        self.cardinality = cardinality
        self.in_channels = in_channels
        self.stem_kernel_t = stem_kernel_t
        kw = dict(device=device, dtype=dtype)
        self.conv1 = nn.Conv3d(in_channels, 64, (stem_kernel_t, 7, 7),
                               stride=(1, 2, 2),
                               padding=(stem_kernel_t // 2, 3, 3),
                               bias=False, **kw)
        self.bn1 = ChannelsFirstBatchNorm(64, **kw)
        self.stages = []
        inplanes = 64
        expansion = ResNeXtBottleneck.expansion
        for stage, (p, blocks) in enumerate(zip(self.planes, self.layers)):
            stride = 1 if stage == 0 else 2
            names = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, ResNeXtBottleneck(
                    inplanes, p, cardinality, s,
                    downsample=b == 0 and (s != 1
                                           or inplanes != p * expansion),
                    **kw))
                inplanes = p * expansion
                names.append(name)
            self.stages.append(names)
        self.fc = nn.Linear(inplanes, num_outputs, **kw)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        dtype = self.conv1.weight.dtype
        h = x.to(dtype).permute(0, 4, 1, 2, 3)
        h = F.relu(self.bn1(self.conv1(h)))
        h = F.max_pool3d(h, 3, stride=2, padding=1)  # pads with -inf
        taps = []
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
            taps.append(h)
        _x1, x2, x3, x4 = taps
        pooled = x4.mean(dim=(2, 3, 4)).to(dtype)
        return (x2.permute(0, 2, 3, 4, 1).to(dtype),
                x3.permute(0, 2, 3, 4, 1).to(dtype),
                x4.permute(0, 2, 3, 4, 1).to(dtype), pooled,
                self.fc(pooled))


def get_rgb_model(num_outputs: int, device=None, dtype=None) -> ResNeXt3D:
    """3-channel (3, 7, 7) stem."""
    return ResNeXt3D(num_outputs, in_channels=3, stem_kernel_t=3,
                     device=device, dtype=dtype)


def get_depth_model(num_outputs: int, device=None, dtype=None) -> ResNeXt3D:
    """1-channel (7, 7, 7) stem."""
    return ResNeXt3D(num_outputs, in_channels=1, stem_kernel_t=7,
                     device=device, dtype=dtype)
