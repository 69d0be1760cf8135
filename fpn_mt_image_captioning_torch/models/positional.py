"""Sinusoidal positional encodings and attention masks (port of
``fpn_mt_image_captioning_tpu/models/positional.py``).

The table is computed host-side in float64 numpy and then cast to float32,
exactly as the JAX package (and the original numpy reference) does, so both
packages hold bit-identical tables.

Masks are float tensors with 1.0 at **disallowed** positions; they enter
attention as ``logits += mask * -1e9``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["raw_positional_encoding", "create_padding_mask", "create_look_ahead_mask",
           "create_masks"]


def _get_angles(pos: np.ndarray, i: np.ndarray, d_model: int) -> np.ndarray:
    angle_rates = 1 / np.power(10000, (2 * (i // 2)) / np.float32(d_model))
    return pos * angle_rates


def raw_positional_encoding(position: int, d_model: int) -> np.ndarray:
    """(position, d_model) float32 sinusoidal table — sin on even dims, cos on odd."""
    angle_rads = _get_angles(
        np.arange(position)[:, np.newaxis],
        np.arange(d_model)[np.newaxis, :],
        d_model,
    )
    angle_rads[:, 0::2] = np.sin(angle_rads[:, 0::2])
    angle_rads[:, 1::2] = np.cos(angle_rads[:, 1::2])
    return angle_rads.astype(np.float32)


def create_padding_mask(seq: torch.Tensor) -> torch.Tensor:
    """(B, L) token ids → (B, 1, 1, L) float mask, 1.0 where pad (id == 0)."""
    return (seq == 0).float()[:, None, None, :]


def create_look_ahead_mask(size: int, device=None) -> torch.Tensor:
    """(L, L) float mask, 1.0 strictly above the diagonal (future positions)."""
    return 1.0 - torch.tril(torch.ones((size, size), device=device))


def create_masks(tar: torch.Tensor) -> torch.Tensor:
    """Decoder self-attention mask: max(padding, look-ahead) → (B, 1, L, L)."""
    return torch.maximum(create_padding_mask(tar),
                         create_look_ahead_mask(tar.shape[1], tar.device))
