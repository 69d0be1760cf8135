"""MobileNetV2 backbone, tapped at C3/C4/C5 for the FPN.

Port of ``fpn_mt_image_captioning_tpu/models/backbones/mobilenet_v2.py``
(Keras ``MobileNetV2`` tapped at ``block_5_add`` / ``block_12_add`` /
``out_relu``, strides 8/16/32). Module names mirror the Flax parameter tree so
``weights.from_flax`` maps leaf for leaf. Runs NCHW. What differs from
PyTorch's defaults: BatchNorm epsilon is Keras' 1e-3, and every 3×3 conv pads
TF-"SAME" (0 before, 1 after on a stride-2 even extent). ``train=True``
normalizes with the batch's statistics and updates the running ones, as
``flax.linen.BatchNorm(use_running_average=False)`` does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm32, SameConv2d

__all__ = ["MobileNetV2Backbone", "make_divisible", "BatchNorm32"]

# (expansion t, channels c, repeats n, first-stride s) — MobileNetV2 paper Table 2
_BLOCK_CONFIG = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),   # → C3 tap (stride 8)
    (6, 64, 4, 2),
    (6, 96, 3, 1),   # → C4 tap (stride 16)
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]
_C3_GROUP, _C4_GROUP = 2, 4


def make_divisible(v: float, divisor: int = 8, min_value: int | None = None) -> int:
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class _ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1, use_relu6: bool = True, bn_momentum: float = 0.999):
        super().__init__()
        self.conv = SameConv2d(cin, cout, kernel, stride, groups=groups, bias=False)
        self.bn = BatchNorm32(cout, momentum=bn_momentum)
        self.use_relu6 = use_relu6

    def forward(self, x, train: bool = False):
        x = self.bn(self.conv(x), train)
        return F.relu6(x) if self.use_relu6 else x


class _InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expansion: int,
                 bn_momentum: float = 0.999):
        super().__init__()
        hidden = cin * expansion
        m = bn_momentum
        self.expand = _ConvBN(cin, hidden, 1, bn_momentum=m) if expansion != 1 else None
        self.depthwise = _ConvBN(hidden, hidden, 3, stride, groups=hidden, bn_momentum=m)
        self.project = _ConvBN(hidden, cout, 1, use_relu6=False, bn_momentum=m)
        self.residual = stride == 1 and cin == cout

    def forward(self, x, train: bool = False):
        h = x if self.expand is None else self.expand(x, train)
        h = self.project(self.depthwise(h, train), train)
        return h + x if self.residual else h


class MobileNetV2Backbone(nn.Module):
    """Returns ``(C3, C4, C5)`` NCHW feature maps at strides 8/16/32.
    ``bn_momentum``: Keras MobileNetV2's 0.999 by default."""

    def __init__(self, alpha: float = 1.0, bn_momentum: float = 0.999):
        super().__init__()
        m = bn_momentum
        first = make_divisible(32 * alpha)
        self.stem = _ConvBN(3, first, 3, 2, bn_momentum=m)
        self._blocks: list[tuple[str, int]] = []
        cin = first
        for gi, (t, c, n, s) in enumerate(_BLOCK_CONFIG):
            out_ch = make_divisible(c * alpha)
            for bi in range(n):
                name = f"block_{gi}_{bi}"
                self.add_module(name, _InvertedResidual(cin, out_ch, s if bi == 0 else 1, t, m))
                self._blocks.append((name, gi))
                cin = out_ch
        last = make_divisible(1280 * alpha) if alpha > 1.0 else 1280
        self.head = _ConvBN(cin, last, 1, bn_momentum=m)
        cfg = _BLOCK_CONFIG
        self.tap_channels = (make_divisible(cfg[_C3_GROUP][1] * alpha),
                             make_divisible(cfg[_C4_GROUP][1] * alpha), last)

    def forward(self, x: torch.Tensor, train: bool = False):
        x = self.stem(x, train)
        taps = {}
        for name, gi in self._blocks:
            x = getattr(self, name)(x, train)
            taps[gi] = x
        return taps[_C3_GROUP], taps[_C4_GROUP], self.head(x, train)
