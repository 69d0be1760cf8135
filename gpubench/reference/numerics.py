"""Roundings for ``model.set_numerics``: float32 (none) for the reference,
and the precisions below the captioner's for the control that each limit
is tested against. A rounding acts on the forward value and, in training,
on the gradient that flows back through it, as a product computed in that
precision sees both: bfloat16 both ways; float8 as fp8 training takes it,
e4m3 forward and e5m2 backward, one scale a tensor (its largest magnitude
to the format's largest value)."""

from __future__ import annotations

import torch


def _scaled(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


def _rounding(forward, backward):
    class Round(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return forward(x)

        @staticmethod
        def backward(ctx, g):
            return backward(g)

    return Round.apply


def float32(x: torch.Tensor) -> torch.Tensor:
    return x


_bf16 = lambda t: t.to(torch.bfloat16).to(t.dtype)
bfloat16 = _rounding(_bf16, _bf16)
fp8 = _rounding(lambda t: _scaled(t, torch.float8_e4m3fn, 448.0),
                lambda t: _scaled(t, torch.float8_e5m2, 57344.0))

NUMERICS = {"float32": float32, "bfloat16": bfloat16, "fp8": fp8}
