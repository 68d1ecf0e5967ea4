"""HCN skeleton backbone (NTU).

Port of ``bmnas_tpu/models/hcn.py`` (the hierarchical co-occurrence
network): per-person position and motion conv streams (motion is the frame
difference, linearly re-interpolated from T-1 back to T frames), point-level
convs, the joints turned into channels, global-level convs, and the two
persons merged by elementwise max. Both persons share the conv weights.

Layout: the skeleton comes in as ``(N, T, V, M, 3)`` channels-last, and
every hidden map goes out channels-last ``(N, H, W, C)``, as in the JAX
package; the convs run in NCHW on cuDNN in between. ``out7`` is flattened
channels-last before ``fc7``, so ``fc7``'s weight maps one to one. As in
the reference, ``fc7``'s input width follows from ``window_size``: the
skeleton has ``window_size`` frames (32 at the NTU defaults).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def motion_of(x: torch.Tensor) -> torch.Tensor:
    """Frame differences of ``(N, T, ...)``, linearly resized from T-1 to
    T along axis 1 with half-pixel centres (``jax.image.resize(...,
    'linear')`` upsamples the same way: an edge frame takes its nearest
    difference)."""
    d = x[:, 1:] - x[:, :-1]
    N, T1 = d.shape[:2]
    flat = d.reshape(N, T1, -1).transpose(1, 2)
    out = F.interpolate(flat, size=T1 + 1, mode="linear",
                        align_corners=False)
    return out.transpose(1, 2).reshape(N, T1 + 1, *d.shape[2:])


class HCN(nn.Module):
    """``forward(x) -> (new_hidden, logits)``; ``new_hidden`` is
    ``[m1..m6, out7, out8]``, each the elementwise max over the persons."""

    def __init__(self, num_outputs: int, drpt: float, in_channel: int = 3,
                 num_joint: int = 25, num_person: int = 2,
                 out_channel: int = 64, window_size: int = 32, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        oc, ws = out_channel, window_size
        self.num_person = num_person

        def conv(c_in, c_out, k, pad):
            return nn.Conv2d(c_in, c_out, k, padding=pad, **kw)
        # position stream, then the motion stream (same shapes)
        self.conv1 = conv(in_channel, oc, 1, 0)
        self.conv2 = conv(oc, ws, (3, 1), (1, 0))
        self.conv3 = conv(num_joint, oc // 2, 3, 1)
        self.conv4 = conv(oc // 2, oc, 3, 1)
        self.conv1m = conv(in_channel, oc, 1, 0)
        self.conv2m = conv(oc, ws, (3, 1), (1, 0))
        self.conv3m = conv(num_joint, oc // 2, 3, 1)
        self.conv4m = conv(oc // 2, oc, 3, 1)
        # merged
        self.conv5 = conv(oc * 2, oc * 2, 3, 1)
        self.conv6 = conv(oc * 2, oc * 4, 3, 1)
        self.fc7 = nn.Linear(oc * 4 * (ws // 16) ** 2, 256 * 2, **kw)
        self.fc8 = nn.Linear(256 * 2, num_outputs, **kw)
        # the reference's init: Xavier-uniform weights, zero biases
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                nn.init.xavier_uniform_(m.weight)
                nn.init.zeros_(m.bias)
        # nn.Dropout2d drops whole channels of an NCHW map
        self.drop_p = nn.Dropout2d(drpt)
        self.drop_m = nn.Dropout2d(drpt)
        self.drop5 = nn.Dropout2d(drpt)
        self.drop6 = nn.Dropout2d(drpt)
        self.drop7 = nn.Dropout(drpt)

    def _stream(self, x: torch.Tensor, c1, c2, c3, c4, drop
                ) -> Tuple[torch.Tensor, ...]:
        """One person's position or motion stream on an NCHW (N, 3, T, V)
        map: (out1, out2, out3, out) in NCHW."""
        out1 = F.relu(c1(x))
        out2 = c2(out1)                      # (N, ws, T, V)
        h = out2.permute(0, 3, 2, 1)         # joints -> channels: (N, V, T, ws)
        out3 = F.max_pool2d(c3(h), 2)
        out = F.max_pool2d(drop(c4(out3)), 2)
        return out1, out2, out3, out

    def forward(self, x: torch.Tensor
                ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        motion = motion_of(x)
        hidden, merged = [], []
        for i in range(self.num_person):
            pos = x[:, :, :, i, :].permute(0, 3, 1, 2)
            mot = motion[:, :, :, i, :].permute(0, 3, 1, 2)
            out1, out2, out3, out_p = self._stream(
                pos, self.conv1, self.conv2, self.conv3, self.conv4,
                self.drop_p)
            *_, out_m = self._stream(mot, self.conv1m, self.conv2m,
                                     self.conv3m, self.conv4m, self.drop_m)
            out4 = torch.cat([out_p, out_m], dim=1)
            out5 = F.max_pool2d(self.drop5(F.relu(self.conv5(out4))), 2)
            out6 = F.max_pool2d(self.drop6(F.relu(self.conv6(out5))), 2)
            # out1 and out2 are (T, V) maps; the JAX package swaps axes
            # only after conv2, so they go back as (N, T, V, C)
            hidden.append([_nhwc(out1), _nhwc(out2), _nhwc(out3),
                           _nhwc(out4), _nhwc(out5), _nhwc(out6)])
            merged.append(out6)
        out7 = _nhwc(torch.maximum(merged[0], merged[1]))
        out7 = out7.reshape(out7.shape[0], -1)
        out8 = self.drop7(F.relu(self.fc7(out7)))
        logits = self.fc8(out8)
        new_hidden = [torch.maximum(a, b) for a, b in zip(*hidden)]
        return new_hidden + [out7, out8], logits
