"""Learning-rate schedules and the optimizer (port of
``fpn_mt_image_captioning_tpu/train/schedule.py``), as plain functions.

* ``custom_schedule`` — the reference's modified Noam schedule,
  ``lr(step) = rsqrt(d)·min(rsqrt(step) / max((step − w)/(2w), 1), step·w^-1.5)``,
  in float32 on the host. ``lr(0) = rsqrt(d)·min(inf, 0) = 0``: the first
  update is zero. The reference builds it with ``dff`` for ``d``
  (``Config.schedule_uses_dff``).
* ``custom_schedule_rough`` — the reference's three-segment schedule, off
  the training path (inventory).
* ``clip_by_per_variable_norm_`` — Keras ``clipnorm``: each gradient is
  clipped by its own L2 norm (``max(norm, 1e-12)``), not by the global one;
  a tensor-parallel shard by the norm of its whole variable.
* ``keras_adam_`` — Adam with AMSGrad in Keras's formulation: the schedule
  read at the count before the increment, ``alpha = lr·sqrt(1 − b2^t)/(1 −
  b1^t)``, the AMSGrad maximum over the uncorrected ``v``, ``eps`` added to
  ``sqrt(v_hat)``; β = (0.9, 0.98), eps 1e-9; the state (``KerasAdamState``:
  count, m, v, vhat) float32. ``torch.optim.Adam(amsgrad=True)`` takes its
  maximum over another quantity, so it is not used.

The tensor updates run as ``torch._foreach_*`` calls over the parameter
list, a few launches a step on the card whatever the number of tensors.
AMSGrad is elementwise, so it runs unchanged on tensor-parallel shards.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..parallel.collectives import sum_over
from ..utils.profiling import annotate

__all__ = ["custom_schedule", "custom_schedule_rough", "clip_by_per_variable_norm_",
           "KerasAdamState", "keras_adam_init", "keras_alpha", "keras_adam_"]

B1, B2, EPS = 0.9, 0.98, 1e-9


def custom_schedule(d_model: int, warmup_steps: int = 4000, multiplier: float = 1.0
                    ) -> Callable[[int], np.float32]:
    f32 = np.float32
    d = f32(d_model)

    def schedule(step: int) -> np.float32:
        step = f32(step)
        with np.errstate(divide="ignore"):
            arg1 = f32(1) / np.sqrt(step) / np.maximum(
                (step - f32(warmup_steps)) * f32(multiplier) / f32(warmup_steps * 2), f32(1))
        arg2 = step * f32(warmup_steps ** -1.5)
        return f32(1) / np.sqrt(d) * np.minimum(arg1, arg2)

    return schedule


def custom_schedule_rough(ratio_x1: float = 5, ratio_x2: float = 2, ratio_x3: float = 3,
                          ratio_y1: float = 1, ratio_y2: float = 0.05, ratio_y3: float = 0.01,
                          max_epoch: int = 50, max_lr: float = 1e-4):
    s = ratio_x1 + ratio_x2 + ratio_x3
    x1 = max_epoch * ratio_x1 // s
    x2 = max_epoch * ratio_x2 // s
    x3 = max_epoch * ratio_x3 // s
    y1, y2, y3 = max_lr * ratio_y1, max_lr * ratio_y2, max_lr * ratio_y3

    def schedule(step) -> np.float32:
        step = np.float32(step)
        seg1 = -(y1 / x1**2) * np.square(step) + 2 * y1 / x1 * step
        seg2 = (y2 - y1) / (x2 - x1) * (step - x1) + y1
        seg3 = (y3 - y2) / (x3 - x2) * (step - x2) + y2
        return np.float32(np.where(step <= x1, seg1, np.where(step <= x2, seg2, seg3)))

    return schedule


@torch.no_grad()
def clip_by_per_variable_norm_(grads: list[torch.Tensor], max_norm: float = 1.0,
                               sharded: list[bool] | None = None, model_group=None) -> None:
    """Scale each gradient in place to at most ``max_norm`` by its own norm.
    The scales come to the host once (one synchronisation, the
    ``train.clip.wait`` span), so the scaling is one ``_foreach`` call
    whatever the number of tensors.

    Under tensor parallelism a gradient marked in ``sharded`` is this rank's
    shard of its variable: its norm is the whole variable's, the square
    root of its squared norm summed over ``model_group`` (one collective for
    all of them)."""
    norms = torch.stack(torch._foreach_norm(grads))
    if model_group is not None and sharded is not None and any(sharded):
        mask = torch.tensor(sharded, device=norms.device)
        whole = sum_over(torch.where(mask, norms * norms, 0.0), model_group).sqrt()
        norms = torch.where(mask, whole, norms)
    scales = torch.clamp(max_norm / torch.clamp(norms, min=1e-12), max=1.0)
    with annotate("train.clip.wait", wait=True):
        scales = scales.tolist()
    torch._foreach_mul_(grads, scales)


class KerasAdamState(NamedTuple):
    count: int
    m: list[torch.Tensor]
    v: list[torch.Tensor]
    vhat: list[torch.Tensor]   # the AMSGrad running maximum of the uncorrected v


def keras_adam_init(params: list[torch.Tensor]) -> KerasAdamState:
    zeros = lambda: [torch.zeros_like(p, dtype=torch.float32) for p in params]
    return KerasAdamState(0, zeros(), zeros(), zeros())


def keras_alpha(lr, count: int, b1: float = B1, b2: float = B2) -> float:
    """``lr·sqrt(1 − b2^t)/(1 − b1^t)`` at ``t = count + 1``, in float32."""
    f32 = np.float32
    t = f32(count + 1)
    return float(f32(lr) * np.sqrt(f32(1) - f32(b2) ** t) / (f32(1) - f32(b1) ** t))


@torch.no_grad()
def keras_adam_(params: list[torch.Tensor], grads: list[torch.Tensor],
                state: KerasAdamState, learning_rate: Callable[[int], float],
                b1: float = B1, b2: float = B2, eps: float = EPS) -> KerasAdamState:
    """One AMSGrad step in place on ``params`` and the moments of ``state``
    (the float32 master weights; ``grads`` float32):

        alpha  = lr(count)·sqrt(1 − b2^t)/(1 − b1^t),  t = count + 1
        m     += (g − m)·(1 − b1)
        v     += (g² − v)·(1 − b2)
        v_hat  = max(v_hat, v)
        p     -= (m·alpha)/(sqrt(v_hat) + eps)

    Returns the state with the count advanced."""
    alpha = keras_alpha(learning_rate(state.count), state.count, b1, b2)
    m, v, vhat = state.m, state.v, state.vhat
    dm = torch._foreach_sub(grads, m)
    torch._foreach_mul_(dm, 1.0 - b1)
    torch._foreach_add_(m, dm)
    dv = torch._foreach_mul(grads, grads)
    torch._foreach_sub_(dv, v)
    torch._foreach_mul_(dv, 1.0 - b2)
    torch._foreach_add_(v, dv)
    torch._foreach_maximum_(vhat, v)
    denom = torch._foreach_sqrt(vhat)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_mul(m, alpha)
    torch._foreach_div_(step, denom)
    torch._foreach_sub_(params, step)
    return KerasAdamState(state.count + 1, m, v, vhat)
