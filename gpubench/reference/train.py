"""The plain float32 training step: the teacher-forced forward with
BatchNorm on the batch's moments and dropout, the masked sparse
cross-entropy, gradients, each gradient clipped to norm 1 by its own norm,
then Adam with AMSGrad in Keras's form on the learning-rate schedule of the
Transformer paper as the captioner modifies it."""

from __future__ import annotations

import math

import numpy as np
import torch

from .model import Dropout

B1, B2, EPS = 0.9, 0.98, 1e-9


def learning_rate(step: int, d: int, warmup: int) -> float:
    """``rsqrt(d)·min(rsqrt(step) / max((step − w)/(2w), 1), step·w^-1.5)``
    in float32; 0 at step 0."""
    f = np.float32
    s = f(step)
    with np.errstate(divide="ignore"):
        a = f(1) / np.sqrt(s) / np.maximum((s - f(warmup)) / f(warmup * 2), f(1))
    return float(f(1) / np.sqrt(f(d)) * np.minimum(a, s * f(warmup ** -1.5)))


def masked_ce(real: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Cross-entropy summed over the non-pad (id 0) targets, over the rows
    that hold a target times the length."""
    lp = torch.log_softmax(logits.float(), -1)
    ce = -lp.gather(-1, real.long()[..., None])[..., 0]
    keep = real != 0
    rows = keep.any(-1).sum().clamp(min=1)
    return (ce * keep).sum() / (rows * real.shape[-1])


class Adam:
    """Keras AMSGrad: ``alpha = lr·sqrt(1 − b2^t)/(1 − b1^t)``, ``m``, ``v``,
    ``vhat = max(vhat, v)``, ``p −= alpha·m/(sqrt(vhat) + eps)``."""

    def __init__(self, params, lr):
        self.params, self.lr, self.count = params, lr, 0
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.vhat = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, grads):
        t = np.float32(self.count + 1)
        alpha = float(np.float32(self.lr(self.count)) * np.sqrt(np.float32(1) - np.float32(B2) ** t)
                      / (np.float32(1) - np.float32(B1) ** t))
        for p, g, m, v, vh in zip(self.params, grads, self.m, self.v, self.vhat):
            m += (g - m) * (1 - B1)
            v += (g * g - v) * (1 - B2)
            torch.maximum(vh, v, out=vh)
            p -= m * alpha / (vh.sqrt() + EPS)
        self.count += 1


def train_steps(model, batches, *, seed: int, dropout: float, d_lr: int, warmup: int,
                ckpt: bool = True, on_step=None, start: dict | None = None) -> list[float]:
    """Run one optimizer step per ``(images, captions)`` of ``batches`` on
    ``model`` in place; returns the losses. ``on_step(i, model, opt, grads)``
    sees each step's clipped gradients after the update. ``start`` resumes a
    training state: Adam's ``count``, the ``step`` whose dropout masks the
    first step draws, and the moments ``m``, ``v``, ``vhat`` in the order of
    the parameters; by default the state is a fresh one at step 0."""
    params = list(model.parameters())
    opt = Adam(params, lambda s: learning_rate(s, d_lr, warmup))
    step0 = 0
    if start is not None:
        opt.count, step0 = start["count"], start["step"]
        dev = params[0].device
        opt.m, opt.v, opt.vhat = ([t.to(dev) for t in start[k]] for k in ("m", "v", "vhat"))
    losses = []
    for i, (images, caps) in enumerate(batches):
        drop = Dropout(dropout, seed, step0 + i, images.device)
        logits = model.forward_train(images, caps[:, :-1], drop, ckpt=ckpt)
        loss = masked_ce(caps[:, 1:], logits)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g.detach() for p, g in zip(params, grads)]
        with torch.no_grad():
            for g in grads:
                g *= min(1.0, 1.0 / max(g.norm().item(), 1e-12))
        opt.step(grads)
        losses.append(loss.item())
        if on_step is not None:
            on_step(i, model, opt, grads)
        del logits, loss
    return losses
