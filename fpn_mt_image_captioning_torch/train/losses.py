"""Loss functions (port of ``fpn_mt_image_captioning_tpu/train/losses.py``).

* ``masked_sparse_ce`` — the training loss: sparse cross-entropy from the
  logits with padding zeroed (the reference's ``Pipeline.loss``).
* ``focal_loss`` / ``smooth_l1_loss`` / ``weighted_mse_loss`` — the
  detection-style losses of the JAX module, plain torch functions (autograd
  gives their gradients), on whatever device their tensors are on.
  ``optax_sigmoid_ce`` keeps the JAX module's name: the numerically stable
  sigmoid cross-entropy ``max(x, 0) - x·z + log1p(exp(-|x|))``.

All reductions accumulate in float32."""

from __future__ import annotations

import torch

from ..parallel.collectives import sum_over

__all__ = ["masked_sparse_ce", "focal_loss", "optax_sigmoid_ce", "smooth_l1_loss",
           "weighted_mse_loss"]


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


def focal_loss(labels: torch.Tensor, logits: torch.Tensor, alpha: float = 0.25,
               gamma: float = 2.0) -> torch.Tensor:
    """RetinaNet focal loss (sigmoid), normalized by the positive count.
    ``labels``: (..., num_classes) one-hot {0, 1}, -1 rows ignored;
    ``logits``: (..., num_classes)."""
    logits = logits.float()
    labels = labels.float()
    valid = (labels >= 0).float()
    labels = torch.clamp(labels, 0.0, 1.0)
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(labels, logits)
    alpha_t = labels * alpha + (1.0 - labels) * (1.0 - alpha)
    p_t = labels * p + (1.0 - labels) * (1.0 - p)
    loss = alpha_t * torch.pow(1.0 - p_t, gamma) * ce * valid
    normalizer = torch.clamp(torch.sum(labels * valid), min=1.0)
    return torch.sum(loss) / normalizer


def optax_sigmoid_ce(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Element-wise sigmoid cross-entropy, stable at large |logits|."""
    return torch.clamp(logits, min=0.0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def weighted_mse_loss(target: torch.Tensor, pred: torch.Tensor,
                      light_background: bool = True) -> torch.Tensor:
    """Brightness-weighted MSE: the per-pixel squared error (mean over the
    last axis) weighted by 1 + the normalized darkness (``light_background``)
    or brightness of ``pred``, summed."""
    target = target.float()
    pred = pred.float()
    err = torch.mean(torch.square(target - pred), dim=-1)
    avg_pred = torch.mean(pred, dim=-1)
    # amin/amax share the gradient among ties, as JAX's min/max do
    min_val = torch.amin(avg_pred)
    max_val = torch.amax(avg_pred)
    norm = (avg_pred - min_val) / torch.clamp(max_val - min_val, min=1e-12)
    ratio = (1.0 - norm) + 1.0 if light_background else norm + 1.0
    return torch.sum(ratio * err)


def smooth_l1_loss(targets: torch.Tensor, preds: torch.Tensor,
                   sigma: float = 3.0) -> torch.Tensor:
    """Smooth-L1 (Huber) regression loss with RetinaNet's sigma
    parameterization, averaged."""
    sigma2 = sigma * sigma
    diff = torch.abs(preds.float() - targets.float())
    loss = torch.where(diff < 1.0 / sigma2, 0.5 * sigma2 * diff * diff, diff - 0.5 / sigma2)
    return torch.mean(loss)
