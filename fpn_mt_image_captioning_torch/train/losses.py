"""The training loss (port of ``masked_sparse_ce`` in
``fpn_mt_image_captioning_tpu/train/losses.py``). The detection losses of
that module are not ported."""

from __future__ import annotations

import torch

from ..parallel.collectives import sum_over

__all__ = ["masked_sparse_ce"]


def masked_sparse_ce(real: torch.Tensor, logits: torch.Tensor, data_group=None) -> torch.Tensor:
    """``real``: (B, L) token ids; ``logits``: (B, L, V). Float32 sparse
    cross-entropy from the logits, padding (id 0) zeroed. The denominator is
    the number of rows that hold any nonzero token (at least 1) times L: a
    full batch gives the mean over the tensor, and the all-zero rows that pad
    a tail batch do not dilute the loss or its gradients.

    With ``data_group`` (a batch split over the ranks of a data group) the
    rows are counted over the global batch, so this rank's value is its
    share of the global loss: the sum over the group is the loss of the
    whole batch, however the padded rows fall."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(log_probs, -1, real.long()[..., None])[..., 0]
    nonzero = real != 0
    real_rows = nonzero.any(dim=-1).sum().to(ce.dtype)
    if data_group is not None:
        real_rows = sum_over(real_rows.detach(), data_group)
    denom = torch.clamp(real_rows, min=1.0) * real.shape[-1]
    return torch.sum(ce * nonzero.to(ce.dtype)) / denom
