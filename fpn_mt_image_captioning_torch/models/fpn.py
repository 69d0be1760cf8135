"""Feature Pyramid Network (P3..P7) on backbone taps C3/C4/C5 (port of
``fpn_mt_image_captioning_tpu/models/fpn.py``), NCHW.

Keeps the reference's two deviations from stock RetinaNet:

  * the top-down path upsamples the *reduced* / *merged* maps (pre-output-conv):
    ``P5_upsampled = resize(C5_reduced)``, ``P4_upsampled = resize(P4_merged)``;
  * P6/P7 are stride-1 3×3 convs followed by a 2× max-pool on ``C5_reduced`` /
    ``P6`` (not stride-2 convs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import SameConv2d, max_pool_2x, upsample_like

__all__ = ["FPN"]


class FPN(nn.Module):
    def __init__(self, c3: int, c4: int, c5: int, feature_size: int = 256):
        super().__init__()
        f = feature_size
        self.C5_reduced = SameConv2d(c5, f, 1)
        self.P5 = SameConv2d(f, f, 3)
        self.C4_reduced = SameConv2d(c4, f, 1)
        self.P4 = SameConv2d(f, f, 3)
        self.C3_reduced = SameConv2d(c3, f, 1)
        self.P3 = SameConv2d(f, f, 3)
        self.P6_conv = SameConv2d(f, f, 3)
        self.P7_conv = SameConv2d(f, f, 3)

    def forward(self, C3: torch.Tensor, C4: torch.Tensor, C5: torch.Tensor):
        P5_reduced = self.C5_reduced(C5)
        P5_upsampled = upsample_like(P5_reduced, C4.shape[2:])
        P5 = F.relu(self.P5(P5_reduced))

        P4_merged = P5_upsampled + self.C4_reduced(C4)
        P4_upsampled = upsample_like(P4_merged, C3.shape[2:])
        P4 = F.relu(self.P4(P4_merged))

        P3 = F.relu(self.P3(P4_upsampled + self.C3_reduced(C3)))

        P6 = max_pool_2x(F.relu(self.P6_conv(P5_reduced)))
        P7 = max_pool_2x(F.relu(self.P7_conv(P6)))
        return [P3, P4, P5, P6, P7]
