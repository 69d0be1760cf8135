"""RetinaNet anchors and box transforms (port of
``fpn_mt_image_captioning_tpu/models/anchors.py``).

The standard RetinaNet anchor scheme over P3..P7: sizes 32..512, strides
8..128, 3 ratios × 3 scales = 9 anchors a location. The anchors are
constants of the image size, computed in numpy exactly as the JAX package
computes them; ``shift_boxes`` and ``box_decode`` work on torch tensors, on
whatever device the tensors are on.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["AnchorParameters", "anchors_for_level", "all_anchors", "shift_boxes", "box_decode"]


class AnchorParameters:
    """Default RetinaNet anchor configuration (P3..P7)."""

    def __init__(
        self,
        sizes=(32, 64, 128, 256, 512),
        strides=(8, 16, 32, 64, 128),
        ratios=(0.5, 1.0, 2.0),
        scales=(2 ** 0, 2 ** (1.0 / 3.0), 2 ** (2.0 / 3.0)),
    ):
        self.sizes = sizes
        self.strides = strides
        self.ratios = np.asarray(ratios, np.float32)
        self.scales = np.asarray(scales, np.float32)

    @property
    def num_anchors(self) -> int:
        return len(self.ratios) * len(self.scales)


def _base_anchors(size: float, ratios: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """(A, 4) anchors centered at the origin, (x1, y1, x2, y2)."""
    num = len(ratios) * len(scales)
    anchors = np.zeros((num, 4), np.float32)
    tiled_scales = np.tile(scales, len(ratios))
    anchors[:, 2] = size * tiled_scales
    anchors[:, 3] = size * tiled_scales
    areas = anchors[:, 2] * anchors[:, 3]
    rep_ratios = np.repeat(ratios, len(scales))
    anchors[:, 2] = np.sqrt(areas / rep_ratios)
    anchors[:, 3] = anchors[:, 2] * rep_ratios
    anchors[:, 0] = -anchors[:, 2] / 2
    anchors[:, 1] = -anchors[:, 3] / 2
    anchors[:, 2] = anchors[:, 2] / 2
    anchors[:, 3] = anchors[:, 3] / 2
    return anchors


def anchors_for_level(feat_h: int, feat_w: int, level: int,
                      params: AnchorParameters | None = None) -> np.ndarray:
    """(H·W·A, 4) anchors for pyramid level ``level`` (3..7)."""
    params = params or AnchorParameters()
    idx = level - 3
    base = _base_anchors(params.sizes[idx], params.ratios, params.scales)
    stride = params.strides[idx]
    sx = (np.arange(feat_w, dtype=np.float32) + 0.5) * stride
    sy = (np.arange(feat_h, dtype=np.float32) + 0.5) * stride
    cx, cy = np.meshgrid(sx, sy)
    shifts = np.stack([cx.ravel(), cy.ravel(), cx.ravel(), cy.ravel()], axis=1)
    return (shifts[:, None, :] + base[None, :, :]).reshape(-1, 4)


def all_anchors(image_size: int, params: AnchorParameters | None = None) -> np.ndarray:
    """Concatenated anchors over P3..P7 for a square image — (ΣH·W·A, 4)."""
    params = params or AnchorParameters()
    out = []
    for level, stride in zip(range(3, 8), params.strides):
        fs = int(np.ceil(image_size / stride))
        out.append(anchors_for_level(fs, fs, level, params))
    return np.concatenate(out, axis=0)


def shift_boxes(boxes: torch.Tensor, deltas: torch.Tensor,
                mean=(0.0, 0.0, 0.0, 0.0), std=(0.2, 0.2, 0.2, 0.2)) -> torch.Tensor:
    """Apply regression deltas (x1, y1, x2, y2 offsets scaled by width/height)."""
    mean = torch.as_tensor(mean, dtype=boxes.dtype, device=boxes.device)
    std = torch.as_tensor(std, dtype=boxes.dtype, device=boxes.device)
    width = boxes[..., 2] - boxes[..., 0]
    height = boxes[..., 3] - boxes[..., 1]
    d = deltas * std + mean
    return torch.stack([boxes[..., 0] + d[..., 0] * width,
                        boxes[..., 1] + d[..., 1] * height,
                        boxes[..., 2] + d[..., 2] * width,
                        boxes[..., 3] + d[..., 3] * height], dim=-1)


def box_decode(anchors, regression: torch.Tensor, image_size: int) -> torch.Tensor:
    """Deltas → clipped absolute boxes for an ``image_size``² input;
    ``anchors`` (numpy or a tensor) move to ``regression``'s device and
    dtype."""
    boxes = shift_boxes(torch.as_tensor(anchors, dtype=regression.dtype,
                                        device=regression.device), regression)
    return torch.clamp(boxes, 0.0, float(image_size))
