"""Sinusoidal positional encodings (port of
``fpn_mt_image_captioning_tpu/models/positional.py``).

The table is computed host-side in float64 numpy and then cast to float32,
exactly as the JAX package (and the original numpy reference) does, so both
packages hold bit-identical tables.
"""

from __future__ import annotations

import numpy as np

__all__ = ["raw_positional_encoding"]


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
