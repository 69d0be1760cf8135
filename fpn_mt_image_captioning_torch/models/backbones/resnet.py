"""ResNet-v1 backbone, tapped at C3/C4/C5 for the FPN (port of
``fpn_mt_image_captioning_tpu/models/backbones/resnet.py``), NCHW.

Bottleneck v1 as Keras applications build it: the stride 2 of a stage's
first block sits on its first 1×1 conv and on the projection shortcut, not on
the 3×3 (torchvision's v1.5 moves it there: the same shapes, other numbers).
Convs have no bias and pad TF-"SAME" (the 7×7 stride-2 stem 2 before and 3
after on an even extent); BatchNorm epsilon is 1.001e-5 and momentum 0.99
(Keras'); the stem's 3×3 max pool is SAME. Module names mirror the Flax tree
(``stem``, ``stage{s}_block{b}`` with ``shortcut``/``conv1``/``conv2``/
``conv3``, each ``{conv, bn}``) so ``weights.from_flax`` maps leaf for leaf.
Taps: stages 1/2/3, (512, 1024, 2048) channels at strides 8/16/32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import BatchNorm32, SameConv2d, max_pool_3x3_same

__all__ = ["ResNetBackbone", "DEPTH_BLOCKS"]

DEPTH_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
_EPS = 1.001e-5


class _ConvBN(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1, relu: bool = True,
                 bn_momentum: float = 0.99):
        super().__init__()
        self.conv = SameConv2d(cin, cout, kernel, stride, bias=False)
        self.bn = BatchNorm32(cout, eps=_EPS, momentum=bn_momentum)
        self.relu = relu

    def forward(self, x, train: bool = False):
        x = self.bn(self.conv(x), train)
        return F.relu(x) if self.relu else x


class _Bottleneck(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1, project: bool = False,
                 bn_momentum: float = 0.99):
        super().__init__()
        m = bn_momentum
        self.shortcut = (_ConvBN(cin, 4 * filters, 1, stride, relu=False, bn_momentum=m)
                         if project else None)
        self.conv1 = _ConvBN(cin, filters, 1, stride, bn_momentum=m)
        self.conv2 = _ConvBN(filters, filters, 3, bn_momentum=m)
        self.conv3 = _ConvBN(filters, 4 * filters, 1, relu=False, bn_momentum=m)

    def forward(self, x, train: bool = False):
        shortcut = x if self.shortcut is None else self.shortcut(x, train)
        h = self.conv3(self.conv2(self.conv1(x, train), train), train)
        return F.relu(h + shortcut)


class ResNetBackbone(nn.Module):
    """Returns ``(C3, C4, C5)`` NCHW feature maps at strides 8/16/32."""

    def __init__(self, depth: int = 50, bn_momentum: float = 0.99):
        super().__init__()
        m = bn_momentum
        self.stem = _ConvBN(3, 64, 7, 2, bn_momentum=m)
        self._stages: list[list[str]] = []
        cin = 64
        for stage, n in enumerate(DEPTH_BLOCKS[depth]):
            filters = 64 * 2**stage
            names = []
            for b in range(n):
                name = f"stage{stage}_block{b}"
                stride = 2 if stage > 0 and b == 0 else 1
                self.add_module(name, _Bottleneck(cin, filters, stride, project=b == 0,
                                                  bn_momentum=m))
                names.append(name)
                cin = 4 * filters
            self._stages.append(names)
        self.tap_channels = (512, 1024, 2048)

    def forward(self, x: torch.Tensor, train: bool = False):
        x = max_pool_3x3_same(self.stem(x, train))
        taps = []
        for names in self._stages:
            for name in names:
                x = getattr(self, name)(x, train)
            taps.append(x)
        return taps[1], taps[2], taps[3]
