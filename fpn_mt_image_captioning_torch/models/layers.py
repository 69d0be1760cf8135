"""Shared layer utilities: image normalization, activations, the float32
LayerNorm, TF-"SAME" convolutions, nearest upsampling and max pooling.

Port of ``fpn_mt_image_captioning_tpu/models/layers.py``. The vision stack of
the port runs in PyTorch's NCHW layout, so ``upsample_like`` and
``max_pool_2x`` take NCHW tensors where the JAX functions take NHWC.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "normalize_images",
    "resolve_activation",
    "LayerNorm32",
    "SameConv2d",
    "upsample_like",
    "max_pool_2x",
]


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """``uint8 RGB → [-1, 1] float32`` (MobileNetV2 ``preprocess_input``:
    ``x/127.5 - 1``); float inputs pass through unchanged."""
    if images.dtype == torch.uint8:
        return images.to(torch.float32) / 127.5 - 1.0
    return images


def resolve_activation(name: str, leaky_alpha: float = 0.2) -> Callable:
    """The model-wide activation by name. leaky_relu's slope is TF's 0.2 (not
    PyTorch's 0.01); gelu is the tanh approximation (``jax.nn.gelu``'s
    default)."""
    if name == "leaky_relu":
        return lambda x: F.leaky_relu(x, negative_slope=leaky_alpha)
    if name == "relu":
        return F.relu
    if name == "relu6":
        return F.relu6
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


class LayerNorm32(nn.LayerNorm):
    """LayerNorm with epsilon 1e-6 (Keras) whose statistics and affine run in
    float32 whatever the input dtype; the result comes back in the input
    dtype. Its parameters stay float32 under a bf16 cast."""

    def __init__(self, d: int, eps: float = 1e-6):
        super().__init__(d, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight.float(),
            self.bias.float(), self.eps,
        ).to(x.dtype)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA/TF "SAME": output ceil(n/s), the odd pad goes after — a stride-2
    3×3 on an even extent pads 0 before and 1 after."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """NCHW ``nn.Conv2d`` with TF/XLA "SAME" padding. Symmetric pads go to the
    convolution itself; an asymmetric one (stride 2) is an explicit
    ``F.pad``, since ``padding=1`` would shift every stride-2 output. An
    empty spatial extent gives the empty output, as Flax's ``nn.Conv`` does
    (the smallest pyramid views of an input below 256²)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        if x.shape[2] == 0 or x.shape[3] == 0:
            return x.new_empty((x.shape[0], self.out_channels,
                                -(-x.shape[2] // sh), -(-x.shape[3] // sw)))
        ph, pw = _same_pads(x.shape[2], kh, sh), _same_pads(x.shape[3], kw, sw)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, self.weight, self.bias, self.stride,
                            (ph[0], pw[0]), 1, self.groups)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, 1, self.groups)


def upsample_like(source: torch.Tensor, target_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of NCHW ``source`` to ``target_hw``; an
    integral factor (always the case in the FPN) is a repeat of each pixel."""
    h, w = source.shape[2:]
    th, tw = target_hw
    if th % h == 0 and tw % w == 0:
        return source.repeat_interleave(th // h, dim=2).repeat_interleave(tw // w, dim=3)
    # half-pixel centres, as jax.image.resize("nearest")
    return F.interpolate(source, size=(th, tw), mode="nearest-exact")


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2×2/stride-2 max pool, VALID padding (Keras MaxPooling2D default). An
    extent below 2 gives the empty (N, C, H//2, W//2), as Flax's
    ``nn.max_pool`` does; ``F.max_pool2d`` refuses it."""
    if x.shape[2] < 2 or x.shape[3] < 2:
        return x.new_empty((*x.shape[:2], x.shape[2] // 2, x.shape[3] // 2))
    return F.max_pool2d(x, kernel_size=2, stride=2)


def he_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Keras/Flax he_normal: a normal truncated at two standard deviations,
    scaled so the truncated draw has variance 2/fan_in."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
