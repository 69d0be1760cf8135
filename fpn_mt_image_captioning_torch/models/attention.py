"""Multi-head attention and the UMV encoder's multi-view attention (port of
``fpn_mt_image_captioning_tpu/models/attention.py``).

Arguments come in (q, k, v) order; softmax runs in float32 whatever the
compute dtype. ``MultiHeadAttention`` also has the KV-cache interface of the
non-fused decode step (``project_kv`` + ``attend_cached``); the fused decode
step's attention lives in ``ops/fused_decoder.py``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["MultiHeadAttention", "MultiViewAttention"]

NEG_INF_SCALE = -1e9  # reference parity: logits += mask * -1e9


class MultiViewAttention(nn.Module):
    """Multi-view cross-attention — one MHA per non-baseline view, queried by
    the baseline stream, summed. The parameters are the JAX module's stacks:
    ``wq``/``wo`` (V, d, d) in (in, out) layout, ``bq``/``bo`` (V, d); each
    layer's K/V projections come in as arguments because the Encoder owns the
    (num_layers, V, d, 2d) stack.

    The JAX module folds the K/V projections into the query side (a TPU op
    count trick) and pads the small views into one stacked group; this port
    projects K/V directly and attends per view unpadded, which computes the
    same function."""

    def __init__(self, num_views: int, d_model: int, num_heads: int):
        super().__init__()
        v, d = num_views, d_model
        self.num_heads = num_heads
        self.wq = nn.Parameter(torch.empty(v, d, d))
        self.bq = nn.Parameter(torch.zeros(v, d))
        self.wo = nn.Parameter(torch.empty(v, d, d))
        self.bo = nn.Parameter(torch.zeros(v, d))

    def forward(
        self,
        baseline: torch.Tensor,             # (B, Lq, d)
        sources: list[torch.Tensor],        # V tensors (B, Lv, d)
        kv_w: torch.Tensor,                 # (V, d, 2d) — [Wk | Wv] per view
        kv_b: torch.Tensor,                 # (V, 2d)
    ) -> torch.Tensor:
        b, lq, d = baseline.shape
        h = self.num_heads
        dh = d // h
        out = 0
        for vi, x in enumerate(sources):
            q = (baseline @ self.wq[vi] + self.bq[vi]).reshape(b, lq, h, dh)
            kv = x @ kv_w[vi] + kv_b[vi]                               # (B, Lv, 2d)
            k = kv[..., :d].reshape(b, -1, h, dh)
            v = kv[..., d:].reshape(b, -1, h, dh)
            logits = torch.einsum("bqhe,blhe->bhql", q, k) * (1.0 / math.sqrt(dh))
            w = torch.softmax(logits.float(), dim=-1).to(q.dtype)
            ctx = torch.einsum("bhql,blhe->bqhe", w, v).reshape(b, lq, d)
            out = out + ctx @ self.wo[vi] + self.bo[vi]
        return out


class MultiHeadAttention(nn.Module):
    """Multi-head attention with separate q/k/v/out projections."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        assert d_model % num_heads == 0
        self.d_model, self.num_heads = d_model, num_heads
        self.depth = d_model // num_heads
        self.wq = nn.Linear(d_model, d_model)
        self.wk = nn.Linear(d_model, d_model)
        self.wv = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, l, _ = x.shape
        return x.reshape(b, l, self.num_heads, self.depth)

    def forward(
        self,
        q: torch.Tensor,  # (B, Lq, d)
        k: torch.Tensor,  # (B, Lk, d)
        v: torch.Tensor,  # (B, Lk, d)
        mask: Optional[torch.Tensor] = None,  # broadcastable to (B, H, Lq, Lk); 1.0 = disallow
    ):
        qh, kh, vh = self._split(self.wq(q)), self._split(self.wk(k)), self._split(self.wv(v))
        logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * (1.0 / math.sqrt(self.depth))
        if mask is not None:
            logits = logits + (mask * NEG_INF_SCALE).to(logits.dtype)
        weights = torch.softmax(logits.float(), dim=-1).to(qh.dtype)
        ctx = torch.einsum("bhqk,bkhd->bqhd", weights, vh)
        return self.out(ctx.reshape(q.shape[0], q.shape[1], self.d_model)), weights

    def project_kv(self, x: torch.Tensor):
        """Keys/values projected once, (B, L, H, D) each."""
        return self._split(self.wk(x)), self._split(self.wv(x))

    def attend_cached(
        self,
        q: torch.Tensor,        # (B, 1, d) — one decode position
        k_cache: torch.Tensor,  # (B, Lmax, H, D)
        v_cache: torch.Tensor,  # (B, Lmax, H, D)
        mask: Optional[torch.Tensor] = None,  # broadcastable to (B, Lmax, 1); 1.0 = disallow
        src: Optional[torch.Tensor] = None,   # (B, Lmax) — beam-ancestry rows
    ) -> torch.Tensor:
        """Single-position attention over a cache. With ``src``, row ``b``
        reads position ``l`` from cache row ``src[b, l]`` (a global row), so
        a beam reorder never rewrites the cache. Logits and softmax run in
        float32, the weights come back in the compute dtype."""
        b, lmax = q.shape[0], k_cache.shape[1]
        qh = self._split(self.wq(q))[:, 0]                          # (B, H, D)
        if src is not None:
            pos = torch.arange(lmax, device=src.device)[None, :]
            k_cache, v_cache = k_cache[src, pos], v_cache[src, pos]
        # the scale rounded to the compute dtype first, as the JAX module has it
        scale = float(torch.tensor(1.0 / math.sqrt(self.depth), dtype=qh.dtype))
        logits = torch.einsum("bhd,blhd->blh", qh, k_cache).float() * scale
        if mask is not None:
            logits = logits + mask * NEG_INF_SCALE
        weights = torch.softmax(logits, dim=1).to(qh.dtype)         # (B, Lmax, H)
        ctx = torch.einsum("blh,blhd->bhd", weights, v_cache)
        return self.out(ctx.reshape(b, 1, self.d_model))
