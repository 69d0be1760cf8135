"""Backbone registry (port of ``fpn_mt_image_captioning_tpu/models/backbones``).

Only ``mobilenet{128,160,192,224}_<alpha>`` (e.g. ``mobilenet224_1.0``) is
ported; the ResNet, VGG and DenseNet backbones of the JAX package are not yet.
"""

from __future__ import annotations

from .mobilenet_v2 import MobileNetV2Backbone

__all__ = ["backbone", "MobileNetV2Backbone"]


def backbone(name: str, bn_momentum: float | None = None):
    """Resolve a backbone name to a module returning ``(C3, C4, C5)``;
    ``bn_momentum`` None keeps the backbone's own default (MobileNetV2: 0.999)."""
    if name.startswith("mobilenet"):
        alpha = float(name.split("_")[1]) if "_" in name else 1.0
        if bn_momentum is None:
            return MobileNetV2Backbone(alpha=alpha)
        return MobileNetV2Backbone(alpha=alpha, bn_momentum=bn_momentum)
    if name.startswith(("resnet", "vgg", "densenet")):
        raise NotImplementedError(f"backbone {name!r} is not ported yet")
    raise ValueError(f"unknown backbone {name!r}")
