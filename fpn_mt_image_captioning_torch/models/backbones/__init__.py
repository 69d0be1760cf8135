"""Backbone registry (port of ``fpn_mt_image_captioning_tpu/models/backbones``):
every name resolves to a module returning NCHW ``(C3, C4, C5)`` taps at
strides 8/16/32, with their channels in ``tap_channels`` (for the FPN).

Names accepted (reference spellings kept):
  * ``mobilenet{128,160,192,224}_<alpha>``  (e.g. ``mobilenet224_1.0``)
  * ``resnet50``, ``resnet101``, ``resnet152``
  * ``vgg16``, ``vgg19``
  * ``densenet121``, ``densenet169``, ``densenet201``
"""

from __future__ import annotations

from torch import nn

from . import densenet, resnet, vgg
from .densenet import DenseNetBackbone
from .mobilenet_v2 import MobileNetV2Backbone
from .resnet import ResNetBackbone
from .vgg import VGGBackbone

__all__ = ["backbone", "MobileNetV2Backbone", "ResNetBackbone", "VGGBackbone",
           "DenseNetBackbone"]

# prefix → (module class, its table keyed by depth)
_FAMILIES = {"resnet": (ResNetBackbone, resnet.DEPTH_BLOCKS),
             "vgg": (VGGBackbone, vgg.BLOCKS),
             "densenet": (DenseNetBackbone, densenet.DEPTH_BLOCKS)}


def backbone(name: str, bn_momentum: float | None = None) -> nn.Module:
    """Resolve a backbone name to its module. ``bn_momentum`` None keeps each
    backbone's Keras default (MobileNetV2 0.999, ResNet and DenseNet 0.99);
    VGG has no BatchNorm and takes none. An unknown name or depth raises
    ``ValueError``."""
    mom = {} if bn_momentum is None else {"bn_momentum": bn_momentum}
    if name.startswith("mobilenet"):
        alpha = float(name.split("_")[1]) if "_" in name else 1.0
        return MobileNetV2Backbone(alpha=alpha, **mom)
    for prefix, (cls, depths) in _FAMILIES.items():
        if name.startswith(prefix):
            depth = name[len(prefix):]
            if not depth.isdigit() or int(depth) not in depths:
                raise ValueError(f"unknown backbone {name!r}: {prefix} depths are "
                                 f"{sorted(depths)}")
            return cls(int(depth)) if cls is VGGBackbone else cls(int(depth), **mom)
    raise ValueError(f"unknown backbone {name!r}")
