"""DenseNet backbone, tapped at C3/C4/C5 for the FPN (port of
``fpn_mt_image_captioning_tpu/models/backbones/densenet.py``), NCHW.

DenseNet-121/169/201 as Keras applications build it, growth rate 32:
pre-activation BN-ReLU-conv layers (a 1×1 to 128 channels, a 3×3 to 32), each
concatenated after its input (``[x, h]``); a transition halves the channels
with a 1×1 conv and halves the extent with a 2×2 VALID average pool. The stem
is a 7×7 stride-2 conv, BN-ReLU and a SAME 3×3 stride-2 max pool. Convs have
no bias; BatchNorm epsilon is 1.001e-5 and momentum 0.99. Module names
mirror the Flax tree (``stem_conv``, ``stem_bn``,
``block{i}_layer{j}/{bn1,conv1,bn2,conv2}``, ``transition{i}/{bn,conv}``).
Taps: the concatenated outputs of dense blocks 3/4/5 at strides 8/16/32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm32, SameConv2d, avg_pool_2x, max_pool_3x3_same

__all__ = ["DenseNetBackbone", "DEPTH_BLOCKS"]

DEPTH_BLOCKS = {121: (6, 12, 24, 16), 169: (6, 12, 32, 32), 201: (6, 12, 48, 32)}
_GROWTH = 32
_EPS = 1.001e-5


class _DenseLayer(nn.Module):
    def __init__(self, cin: int, bn_momentum: float = 0.99):
        super().__init__()
        self.bn1 = BatchNorm32(cin, eps=_EPS, momentum=bn_momentum)
        self.conv1 = SameConv2d(cin, 4 * _GROWTH, 1, bias=False)
        self.bn2 = BatchNorm32(4 * _GROWTH, eps=_EPS, momentum=bn_momentum)
        self.conv2 = SameConv2d(4 * _GROWTH, _GROWTH, 3, bias=False)

    def forward(self, x, train: bool = False):
        h = self.conv1(F.relu(self.bn1(x, train)))
        h = self.conv2(F.relu(self.bn2(h, train)))
        return torch.cat([x, h], dim=1)


class _Transition(nn.Module):
    def __init__(self, cin: int, bn_momentum: float = 0.99):
        super().__init__()
        self.bn = BatchNorm32(cin, eps=_EPS, momentum=bn_momentum)
        self.conv = SameConv2d(cin, cin // 2, 1, bias=False)

    def forward(self, x, train: bool = False):
        return avg_pool_2x(self.conv(F.relu(self.bn(x, train))))


class DenseNetBackbone(nn.Module):
    """Returns ``(C3, C4, C5)`` NCHW feature maps at strides 8/16/32."""

    def __init__(self, depth: int = 121, bn_momentum: float = 0.99):
        super().__init__()
        m = bn_momentum
        self.stem_conv = SameConv2d(3, 64, 7, 2, bias=False)
        self.stem_bn = BatchNorm32(64, eps=_EPS, momentum=m)
        self._blocks: list[tuple[list[str], str | None]] = []
        blocks = DEPTH_BLOCKS[depth]
        c, taps = 64, []
        for bi, n in enumerate(blocks):
            names = [f"block{bi + 2}_layer{li}" for li in range(n)]
            for name in names:
                self.add_module(name, _DenseLayer(c, m))
                c += _GROWTH
            taps.append(c)
            transition = None
            if bi != len(blocks) - 1:
                transition = f"transition{bi + 1}"
                self.add_module(transition, _Transition(c, m))
                c //= 2
            self._blocks.append((names, transition))
        self.tap_channels = tuple(taps[1:])

    def forward(self, x: torch.Tensor, train: bool = False):
        x = max_pool_3x3_same(F.relu(self.stem_bn(self.stem_conv(x), train)))
        taps = []
        for names, transition in self._blocks:
            for name in names:
                x = getattr(self, name)(x, train)
            taps.append(x)
            if transition is not None:
                x = getattr(self, transition)(x, train)
        return taps[1], taps[2], taps[3]
