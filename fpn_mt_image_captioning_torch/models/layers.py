"""Shared layer utilities: image normalization, activations, the float32
LayerNorm and BatchNorm (with the global moments of a batch split over
ranks), the dense layer (with its tensor-parallel shards), TF-"SAME"
convolutions, nearest upsampling, max and average pooling and
training-mode dropout.

Port of ``fpn_mt_image_captioning_tpu/models/layers.py``. The vision stack of
the port runs in PyTorch's NCHW layout, so ``upsample_like`` and
``max_pool_2x`` take NCHW tensors where the JAX functions take NHWC. The
pools of the ResNet, VGG and DenseNet backbones (Flax ``nn.max_pool`` /
``nn.avg_pool`` inline in the JAX modules) are ``max_pool_3x3_same`` and
``avg_pool_2x`` here.

Mixed precision as Flax's ``dtype=`` does it: ``Dense`` and ``SameConv2d``
cast their weights to the dtype of their input inside the op, so float32
parameters train under a bfloat16 compute dtype and receive float32
gradients (a weight already in the input's dtype is used as it is).
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import sum_over, sum_partials

__all__ = [
    "normalize_images",
    "resolve_activation",
    "LayerNorm32",
    "BatchNorm32",
    "Dense",
    "SameConv2d",
    "upsample_like",
    "max_pool_2x",
    "avg_pool_2x",
    "max_pool_3x3_same",
    "Dropout",
    "dropout",
]


def cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``; ``t`` itself where it has that dtype already, as
    ``Tensor.to`` returns it, but without the cast node and metadata check
    that a ``torch.export`` trace records for ``t.to(dtype)`` (they were half
    the nodes of an exported decode program)."""
    return t if t.dtype == dtype else t.to(dtype)


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
        f32 = torch.float32
        return cast(F.layer_norm(cast(x, f32), self.normalized_shape, cast(self.weight, f32),
                                 cast(self.bias, f32), self.eps), x.dtype)


class BatchNorm32(nn.Module):
    """BatchNorm over NCHW channels, computed in float32 whatever the input
    dtype (Flax promotes to the float32 statistics the same way); the result
    comes back in the input's dtype. ``eps`` is the backbone's: Keras
    MobileNetV2's 1e-3, ResNet's and DenseNet's 1.001e-5.

    Inference normalizes with the running statistics. Training follows Flax
    0.12's ``_compute_stats``: float32 batch moments over (N, H, W), ``var =
    E[x²] − E[x]²`` clamped at 0 (``use_fast_variance``), that biased
    variance both to normalize and in the running update ``ra = m·ra +
    (1 − m)·batch`` with ``m = momentum`` (Keras' convention, the opposite of
    ``F.batch_norm``'s, which also keeps an unbiased running variance).

    Under data parallelism (``data_group``, set by
    ``parallel.train.shard_state``) the training moments are those of the
    global batch, as the JAX package's sharded step takes them: the sums of
    x and x² and the count over the data group, with the gradient through
    the sums (SyncBatchNorm's semantics), and the running statistics move
    with those global moments on every rank."""

    data_group = None

    def __init__(self, c: int, eps: float = 1e-3, momentum: float = 0.999):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            f32 = torch.float32
            return cast(F.batch_norm(
                cast(x, f32), cast(self.running_mean, f32), cast(self.running_var, f32),
                cast(self.weight, f32), cast(self.bias, f32), False, 0.0, self.eps,
            ), x.dtype)
        x32 = x.float()
        if self.data_group is None:
            mean = x32.mean(dim=(0, 2, 3))
            mean_sq = (x32 * x32).mean(dim=(0, 2, 3))
        else:
            n = x32.new_full((1,), x32.numel() // x32.shape[1])
            sums = sum_over(torch.cat([x32.sum(dim=(0, 2, 3)), (x32 * x32).sum(dim=(0, 2, 3)),
                                       n]), self.data_group)
            mean, mean_sq = (sums[:-1] / sums[-1]).chunk(2)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in the dtype of its input.

    Under tensor parallelism (``parallel.train.shard_state`` sets
    ``tp_group`` and ``tp_row``) the weight is this rank's shard: a
    column-parallel layer computes its slice of the outputs (the caller
    passes its input through ``collectives.replicated_input``); a
    row-parallel one (``tp_row``) sums its partial product over the model
    group before the whole bias."""

    tp_group = None
    tp_row = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp_row and self.tp_group is not None:
            y = sum_partials(F.linear(x, cast(self.weight, x.dtype)), self.tp_group)
            return y + cast(self.bias, x.dtype)
        return F.linear(x, cast(self.weight, x.dtype), cast(self.bias, x.dtype))


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
        weight = cast(self.weight, x.dtype)
        bias = None if self.bias is None else cast(self.bias, x.dtype)
        ph, pw = _same_pads(x.shape[2], kh, sh), _same_pads(x.shape[3], kw, sw)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            return F.conv2d(x, weight, bias, self.stride, (ph[0], pw[0]), 1, self.groups)
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        return F.conv2d(x, weight, bias, self.stride, 0, 1, self.groups)


def upsample_like(source: torch.Tensor, target_hw: tuple[int, int]) -> torch.Tensor:
    """Nearest-neighbour resize of NCHW ``source`` to ``target_hw``; an
    integral factor (always the case in the FPN) is a repeat of each pixel."""
    h, w = source.shape[2:]
    th, tw = target_hw
    if th % h == 0 and tw % w == 0:
        return source.repeat_interleave(th // h, dim=2).repeat_interleave(tw // w, dim=3)
    # half-pixel centres, as jax.image.resize("nearest")
    return F.interpolate(source, size=(th, tw), mode="nearest-exact")


def _pool_2x(x: torch.Tensor, pool: Callable) -> torch.Tensor:
    if x.shape[2] < 2 or x.shape[3] < 2:
        return x.new_empty((*x.shape[:2], x.shape[2] // 2, x.shape[3] // 2))
    return pool(x, kernel_size=2, stride=2)


def max_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2×2/stride-2 max pool, VALID padding (Keras MaxPooling2D default). An
    extent below 2 gives the empty (N, C, H//2, W//2), as Flax's
    ``nn.max_pool`` does; ``F.max_pool2d`` refuses it."""
    return _pool_2x(x, F.max_pool2d)


def avg_pool_2x(x: torch.Tensor) -> torch.Tensor:
    """2×2/stride-2 average pool, VALID padding (Flax ``nn.avg_pool``'s
    default: DenseNet's transitions); below 2, the empty map as
    ``max_pool_2x``."""
    return _pool_2x(x, F.avg_pool2d)


def max_pool_3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3×3/stride-2 max pool with TF/XLA "SAME" padding (the ResNet and
    DenseNet stems): Flax pads −inf, 0 before and 1 after on an even extent.
    ``F.max_pool2d(padding=1)`` would pad both sides and shift every window,
    so the pad is explicit, as in ``SameConv2d``. An empty extent stays empty."""
    h, w = x.shape[2:]
    if h == 0 or w == 0:
        return x.new_empty((*x.shape[:2], -(-h // 2), -(-w // 2)))
    (ht, hb), (wl, wr) = _same_pads(h, 3, 2), _same_pads(w, 3, 2)
    return F.max_pool2d(F.pad(x, (wl, wr, ht, hb), value=float("-inf")), 3, 2)


def he_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """Keras/Flax he_normal: a normal truncated at two standard deviations,
    scaled so the truncated draw has variance 2/fan_in."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)


class Dropout:
    """The dropout masks of one training step. Each site (a stable name, such
    as ``"decoder.layer_0.dropout2"``) draws its mask from a generator on
    ``device`` seeded with a hash of ``(seed, step, site)``: a pure function,
    as the JAX package folds the step into its key, so a resumed run draws
    the same masks, and a recompute under ``torch.utils.checkpoint`` (which
    restores only the global RNG, not this generator) draws the same mask as
    the forward it repeats. Kept values are scaled by ``1 / (1 - rate)``, as
    ``flax.linen.Dropout`` scales them; the bits differ from JAX's threefry.

    ``rows``: ``(first row, rows of the global batch)`` where this rank holds
    a share of a batch split over ranks: each site draws the mask of the
    global batch and keeps this rank's rows, so the masks depend on neither
    the rank nor the number of ranks."""

    def __init__(self, rate: float, seed: int, step: int, device: torch.device,
                 rows: tuple[int, int] | None = None):
        self.rate, self.seed, self.step, self.rows = rate, seed, step, rows
        self.generator = torch.Generator(device=device)

    def site_seed(self, site: str) -> int:
        digest = hashlib.blake2b(f"{self.seed}/{self.step}/{site}".encode(), digest_size=8)
        return int.from_bytes(digest.digest(), "little") >> 1

    def __call__(self, x: torch.Tensor, site: str) -> torch.Tensor:
        if self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        self.generator.manual_seed(self.site_seed(site))
        first, total = self.rows or (0, x.shape[0])
        mask = torch.rand((total, *x.shape[1:]), generator=self.generator,
                          device=x.device)[first:first + x.shape[0]] < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, drop: Dropout | None, site: str) -> torch.Tensor:
    """``drop(x, site)`` while training; ``x`` itself when ``drop`` is None."""
    return x if drop is None else drop(x, site)
