"""Inflated 3D ResNet-50 (NTU RGB backbone).

Port of ``bmnas_tpu/models/inflated_resnet.py``: a 2-D 7x7/2 stem applied
to every frame, then four stages of Bottleneck3D blocks (1x1x1, 3x3x3,
1x1x1; the stride is spatial only), the feature map tapped after every
stage.

Layout: clips come in channels-last ``(B, T, H, W, C)`` and the taps go out
the same way, as in the JAX package; in between the convolutions run
channels-first on cuDNN (the frames folded into the batch for the stem).
The taps are permuted views, so a tap nobody reads costs nothing. They
come back in the parameters' dtype: fp32 unless the whole net was cast to
bf16 for serving.

``remat=True`` runs each Bottleneck3D under ``torch.utils.checkpoint``
when it builds a backward: only the blocks' inputs are kept, and each block
is run again in the backward. The rerun leaves the BatchNorm running
statistics alone (``ops.layers.recomputing``), so they move once a step,
as without remat and as in the JAX package's ``nn.remat``.
"""
from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from torch.utils.checkpoint import checkpoint

from bmnas_tpu_torch.ops.layers import ChannelsFirstBatchNorm, recomputing


class Bottleneck3D(nn.Module):
    """1x1x1 -> 3x3x3 (stride (1, s, s), padding 1) -> 1x1x1, each with
    BatchNorm, and a 1x1x1 strided projection of the residual where the
    shape changes. Channels-first ``(B, C, T, H, W)``."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, remat: bool = False, device=None,
                 dtype=None):
        super().__init__()
        self.remat = remat
        kw = dict(bias=False, device=device, dtype=dtype)
        bn = dict(device=device, dtype=dtype)
        self.conv1 = nn.Conv3d(inplanes, planes, 1, **kw)
        self.bn1 = ChannelsFirstBatchNorm(planes, **bn)
        self.conv2 = nn.Conv3d(planes, planes, 3, stride=(1, stride, stride),
                               padding=1, **kw)
        self.bn2 = ChannelsFirstBatchNorm(planes, **bn)
        self.conv3 = nn.Conv3d(planes, planes * 4, 1, **kw)
        self.bn3 = ChannelsFirstBatchNorm(planes * 4, **bn)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = nn.Conv3d(
                inplanes, planes * 4, 1, stride=(1, stride, stride), **kw)
            self.downsample_bn = ChannelsFirstBatchNorm(planes * 4, **bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and torch.is_grad_enabled()):
            return self._block(x)
        # the forward runs as it is, the backward's rerun under recomputing()
        return checkpoint(self._block, x, use_reentrant=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              recomputing()))

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = (self.downsample_bn(self.downsample_conv(x))
                    if self.downsample else x)
        return F.relu(out + residual)


class InflatedResNet50(nn.Module):
    """Stem (2-D, per frame) + ``layers`` stages of Bottleneck3D; returns
    the four stage taps ``(B, T, H, W, C)``: 256, 512, 1024 and 2048
    channels at the default widths. ``remat`` reruns each block in the
    backward instead of keeping its activations."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3),
                 channels: Tuple[int, ...] = (64, 128, 256, 512),
                 remat: bool = False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False,
                               **kw)
        self.bn1 = ChannelsFirstBatchNorm(64, **kw)
        self.stages = []
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip(channels, layers)):
            stride = 1 if stage == 0 else 2
            names = []
            for b in range(blocks):
                s = stride if b == 0 else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Bottleneck3D(
                    inplanes, planes, s,
                    downsample=b == 0 and (s != 1 or inplanes != planes * 4),
                    remat=remat, **kw))
                inplanes = planes * 4
                names.append(name)
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        B, T, H, W, C = x.shape
        h = x.reshape(B * T, H, W, C).permute(0, 3, 1, 2)
        h = F.relu(self.bn1(self.conv1(h)))
        h = F.max_pool2d(h, 3, stride=2, padding=1)  # pads with -inf
        h = h.reshape(B, T, *h.shape[1:]).transpose(1, 2)  # (B, C, T, H, W)
        taps = []
        for names in self.stages:
            for name in names:
                h = getattr(self, name)(h)
            taps.append(h.permute(0, 2, 3, 4, 1))
        return tuple(taps)
