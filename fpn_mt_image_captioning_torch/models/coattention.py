"""Spatial co-attention fusion (port of
``fpn_mt_image_captioning_tpu/models/coattention.py``): a 1-channel score map
is softmaxed over its flattened H×W positions, in float32, and the weights
scale every channel of the feature map."""

from __future__ import annotations

import torch

__all__ = ["coattention"]


def coattention(score: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    """``score``: (B, 1, H, W) logits; ``hs``: (B, C, H, W) features (NCHW).
    Returns (B, C, H, W) = softmax_{H·W}(score) * hs."""
    b, _, h, w = score.shape
    weights = torch.softmax(score.reshape(b, h * w).float(), dim=1).to(hs.dtype)
    return weights.reshape(b, 1, h, w) * hs
