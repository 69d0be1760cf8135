"""The Gumbel noise of sampling, drawn one decode step at a time: the draw
``sample_decode`` makes each step, and that ``export.ExportedServing`` makes
ahead of a sampling program (which takes its noise as an input)."""

from __future__ import annotations

import torch

__all__ = ["gumbel"]


def gumbel(generator: torch.Generator, shape, device,
           rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Standard Gumbel noise from ``generator``: -log(-log(U)). ``rows``:
    ``(first row, rows of the global batch)`` of a rank that holds a share
    of the batch: the noise of the global batch is drawn and this rank's
    rows kept, so a sharded draw equals the unsharded one row for row."""
    first, total = rows or (0, shape[0])
    u = torch.rand((total, *shape[1:]), generator=generator, device=device)
    return -torch.log(-torch.log(u[first:first + shape[0]]))
