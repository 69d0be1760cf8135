"""The Gumbel noise of sampling, drawn one decode step at a time: the draw
``sample_decode`` makes each step, and that ``export.ExportedServing`` makes
ahead of a sampling program (which takes its noise as an input)."""

from __future__ import annotations

import torch

__all__ = ["gumbel"]


def gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise from ``generator``: -log(-log(U))."""
    return -torch.log(-torch.log(torch.rand(shape, generator=generator, device=device)))
