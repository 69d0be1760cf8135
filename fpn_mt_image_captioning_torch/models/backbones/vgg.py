"""VGG backbone, tapped at C3/C4/C5 for the FPN (port of
``fpn_mt_image_captioning_tpu/models/backbones/vgg.py``), NCHW.

VGG16/19 as Keras applications build it: 3×3 TF-"SAME" convs with bias and
ReLU, no BatchNorm, a 2×2 VALID max pool after each block (an extent below 2
pools to the empty map, as Flax's does). Module names mirror the Flax tree
(``block{i}_conv{j}``). Taps: the block 3/4/5 pools, (256, 512, 512) channels
at strides 8/16/32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import SameConv2d, max_pool_2x

__all__ = ["VGGBackbone", "BLOCKS"]

# (features, convs) of each block
BLOCKS = {
    16: ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)),
    19: ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4)),
}


class VGGBackbone(nn.Module):
    """Returns ``(C3, C4, C5)`` NCHW feature maps at strides 8/16/32."""

    def __init__(self, depth: int = 16):
        super().__init__()
        self._blocks: list[list[str]] = []
        cin = 3
        for bi, (feats, reps) in enumerate(BLOCKS[depth]):
            names = [f"block{bi + 1}_conv{ci + 1}" for ci in range(reps)]
            for name in names:
                self.add_module(name, SameConv2d(cin, feats, 3))
                cin = feats
            self._blocks.append(names)
        self.tap_channels = tuple(feats for feats, _ in BLOCKS[depth][2:])

    def forward(self, x: torch.Tensor, train: bool = False):
        del train  # no batch statistics in VGG
        taps = []
        for names in self._blocks:
            for name in names:
                x = F.relu(getattr(self, name)(x))
            x = max_pool_2x(x)
            taps.append(x)
        return taps[2], taps[3], taps[4]
