"""Weights across the two packages, and the port's own seeded init.

``from_flax`` turns the JAX package's ``{"params", "batch_stats"}`` variables —
a nested dict of numpy arrays, so no flax is needed — into a state dict for
``models.transformer.Transformer``, whose module names mirror the Flax tree:

  * Dense kernels ``(in, out)`` → ``nn.Linear.weight`` ``(out, in)``;
  * conv kernels HWIO → OIHW (a depthwise ``(3, 3, 1, C)`` becomes
    ``(C, 1, 3, 3)``, the ``groups=C`` layout);
  * LayerNorm / BatchNorm ``scale`` → ``weight``; BatchNorm statistics
    ``mean``/``var`` → ``running_mean``/``running_var``;
  * ``embedding`` → ``nn.Embedding.weight``;
  * the stacks — the encoder's ``kv_proj``/``kv_bias`` and each layer's
    ``mva`` ``wq/bq/wo/bo`` — keep their names and the JAX layout.

Reading Flax msgpack or Orbax checkpoint files is not ported yet.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .models.attention import MultiViewAttention
from .models.backbones.mobilenet_v2 import BatchNorm32
from .models.layers import he_normal_
from .models.transformer import Encoder

__all__ = ["from_flax", "init_weights"]

_RENAME = {"scale": "weight", "embedding": "weight",
           "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def from_flax(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX package variables (numpy leaves) → a float32 state dict for
    ``Transformer.load_state_dict(..., strict=True)``."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            a = np.array(leaf, np.float32)   # a writable copy
            *mods, name = path
            if name == "kernel":
                name = "weight"
                if a.ndim == 4:
                    a = a.transpose(3, 2, 0, 1)     # HWIO → OIHW
                elif a.ndim == 2:
                    a = a.T                         # (in, out) → (out, in)
                else:
                    raise ValueError(f"unexpected kernel rank at {'/'.join(path)}: {a.shape}")
            else:
                name = _RENAME.get(name, name)
            state[".".join([*mods, name])] = torch.from_numpy(np.ascontiguousarray(a))
    return state


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded init of every parameter and statistic, drawn from
    ``generator`` only: he_normal for dense, conv and stacked projection
    kernels, zero biases, U(-0.05, 0.05) embeddings (Keras' default), unit
    norm scales, BatchNorm statistics (0, 1). The JAX package uses the same
    families (and glorot/lecun/normal(0.01) for a few convs); the draws differ,
    since the generators do."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            he_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Linear):
            he_normal_(m.weight, m.in_features, generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.uniform_(-0.05, 0.05, generator=generator)
        elif isinstance(m, (nn.LayerNorm, BatchNorm32)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, BatchNorm32):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        elif isinstance(m, MultiViewAttention):
            for w in (m.wq, m.wo):
                he_normal_(w, w.shape[-2], generator)
            m.bq.zero_()
            m.bo.zero_()
        elif isinstance(m, Encoder):
            he_normal_(m.kv_proj, m.kv_proj.shape[-2], generator)
            m.kv_bias.zero_()
