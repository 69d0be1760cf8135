"""Vision feature extractor: backbone → FPN → shared head trunks → co-attention
→ projection, producing the five pyramid "views" for the multi-view encoder
(port of ``fpn_mt_image_captioning_tpu/models/feature_extractor.py``), NCHW.

  * head trunks = ``n_conv_submodule`` 3×3 conv+ReLU layers, 256 filters, with
    weights *shared across the five pyramid levels*;
  * new final convs: regression → 1 channel ("score"), classification → 256;
  * co-attention, then conv(256, act) → 2× max-pool → conv(d_model, act).

For a 512² input the views are 32², 16², 8², 4² and 2², each ``d_model`` wide.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .backbones import backbone as resolve_backbone
from .coattention import coattention
from .fpn import FPN
from .layers import SameConv2d, max_pool_2x, resolve_activation

__all__ = ["FeatureExtractor"]


class _HeadTrunk(nn.Module):
    """Shared 3×3 conv+ReLU trunk (the surviving prefix of a RetinaNet head)."""

    def __init__(self, n_convs: int, features: int):
        super().__init__()
        self.n_convs = n_convs
        for i in range(n_convs):
            self.add_module(f"conv_{i}", SameConv2d(features, features, 3))

    def forward(self, x):
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        return x


class FeatureExtractor(nn.Module):
    def __init__(self, backbone_name: str = "mobilenet224_1.0", d_model: int = 512,
                 feature_size: int = 256, n_conv_submodule: int = 2,
                 activation: str = "leaky_relu", leaky_relu_alpha: float = 0.2):
        super().__init__()
        f = feature_size
        self.backbone = resolve_backbone(backbone_name)
        self.fpn = FPN(*self.backbone.tap_channels, feature_size=f)
        self.regression_trunk = _HeadTrunk(n_conv_submodule, f)
        self.classification_trunk = _HeadTrunk(n_conv_submodule, f)
        self.regression_final = SameConv2d(f, 1, 3)
        self.classification_final = SameConv2d(f, f, 3)
        self.fuse_conv1 = SameConv2d(f, f, 3)
        self.fuse_conv2 = SameConv2d(f, d_model, 3)
        self.act = resolve_activation(activation, leaky_relu_alpha)

    def _per_level(self, feature: torch.Tensor) -> torch.Tensor:
        score = self.regression_final(self.regression_trunk(feature))
        hs = self.classification_final(self.classification_trunk(feature))
        out = self.act(self.fuse_conv1(coattention(score, hs)))
        return self.act(self.fuse_conv2(max_pool_2x(out)))

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        """``images``: (B, 3, S, S) in [-1, 1], in the model's dtype. Returns
        the five views (B, d_model, S/16 … S/256, same)."""
        C3, C4, C5 = self.backbone(images)
        return [self._per_level(p) for p in self.fpn(C3, C4, C5)]

    def from_taps(self, C3: torch.Tensor, C4: torch.Tensor, C5: torch.Tensor) -> list[torch.Tensor]:
        """FPN + heads from precomputed NHWC backbone taps (the fused-backbone
        path, ``ops/fused_backbone.py``); each is turned to NCHW once, in the
        model's dtype."""
        dtype = self.fuse_conv1.weight.dtype
        C3, C4, C5 = (c.permute(0, 3, 1, 2).to(dtype).contiguous() for c in (C3, C4, C5))
        return [self._per_level(p) for p in self.fpn(C3, C4, C5)]
