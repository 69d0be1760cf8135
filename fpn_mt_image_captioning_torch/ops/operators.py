"""The hand-written kernels as custom operators (namespace ``fpn_mt``), the
nodes an exported program (``export.py``) holds for them.

``torch.export`` cannot trace a ``ctypes`` launch. Each operator here calls
its kernel's wrapper (``ops/fused_decoder.py``, ``ops/fused_backbone.py``),
which launches the kernel (and counts) on a CUDA tensor and takes the plain
version on a CPU one; its fake implementation gives the tracer the result's
shape. The self-attention operator writes the caches in place
(``mutates_args``), so an exported step keeps its cache writes in place
instead of copying the caches.

The operators are registered once, here, bound to those modules' wrappers: a
second instance of ``ops/fused_decoder.py`` (the probes' empty-bodied
decoder) registers nothing. ``CUSTOM_OPS`` is the decode step's five in
``decode_step_with``'s calling convention; ``OP_NAMES`` names the operator
of each wrapper.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from .fused_backbone import fused_ir_block
from .fused_decoder import (decoder_add_layernorm, decoder_cross_attention, decoder_linear,
                            decoder_logsoftmax_topk, decoder_self_attention)

__all__ = ["CUSTOM_OPS", "OP_NAMES", "ir_block_via_op"]


@torch.library.custom_op("fpn_mt::decoder_linear", mutates_args=())
def _linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, act: str,
            out_f32: bool) -> torch.Tensor:
    return decoder_linear(x, w, b, act, out_f32)


@_linear.register_fake
def _(x, w, b, act, out_f32):
    return x.new_empty((x.shape[0], w.shape[1]), dtype=torch.float32 if out_f32 else x.dtype)


@torch.library.custom_op("fpn_mt::decoder_add_layernorm", mutates_args=())
def _add_layernorm(y: torch.Tensor, r: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   out_dtype: torch.dtype) -> list[torch.Tensor]:
    """[float32 result, its cast to ``out_dtype``], or the one float32 result
    when ``out_dtype`` is float32 (an operator returns no tensor twice)."""
    out_f, out_t = decoder_add_layernorm(y, r, gamma, beta, out_dtype)
    return [out_f] if out_f is out_t else [out_f, out_t]


@_add_layernorm.register_fake
def _(y, r, gamma, beta, out_dtype):
    out_f = y.new_empty(y.shape)
    return [out_f] if out_dtype == torch.float32 else [out_f, y.new_empty(y.shape, dtype=out_dtype)]


@torch.library.custom_op("fpn_mt::decoder_self_attention", mutates_args=("k_self", "v_self"))
def _self_attention(qkv: torch.Tensor, k_self: torch.Tensor, v_self: torch.Tensor, layer: int,
                    pos: int, src_t: torch.Tensor, beam: int, num_heads: int) -> torch.Tensor:
    return decoder_self_attention(qkv, k_self, v_self, layer, pos, src_t, beam, num_heads)


@_self_attention.register_fake
def _(qkv, k_self, v_self, layer, pos, src_t, beam, num_heads):
    return qkv.new_empty((qkv.shape[0], qkv.shape[1] // 3))


@torch.library.custom_op("fpn_mt::decoder_cross_attention", mutates_args=())
def _cross_attention(q: torch.Tensor, kv_cross: torch.Tensor, layer: int, beam: int,
                     num_heads: int) -> torch.Tensor:
    return decoder_cross_attention(q, kv_cross, layer, beam, num_heads)


@_cross_attention.register_fake
def _(q, kv_cross, layer, beam, num_heads):
    return q.new_empty(q.shape)


@torch.library.custom_op("fpn_mt::decoder_logsoftmax_topk", mutates_args=())
def _logsoftmax_topk(logits: torch.Tensor, scores: torch.Tensor, finished: torch.Tensor,
                     topk: int) -> tuple[torch.Tensor, torch.Tensor]:
    return decoder_logsoftmax_topk(logits, scores, finished, topk)


@_logsoftmax_topk.register_fake
def _(logits, scores, finished, topk):
    return (logits.new_empty((logits.shape[0], topk)),
            logits.new_empty((logits.shape[0], topk), dtype=torch.int32))


@torch.library.custom_op("fpn_mt::fused_ir_block", mutates_args=())
def _ir_block(x: torch.Tensor, w_exp: torch.Tensor | None, b_exp: torch.Tensor | None,
              w_dw: torch.Tensor, b_dw: torch.Tensor, w_proj: torch.Tensor, b_proj: torch.Tensor,
              stride: int, residual: bool) -> torch.Tensor:
    blk = {"w_dw": w_dw, "b_dw": b_dw, "w_proj": w_proj, "b_proj": b_proj}
    if w_exp is not None:
        blk.update(w_exp=w_exp, b_exp=b_exp)
    return fused_ir_block(x, blk, stride=stride, residual=residual)


@_ir_block.register_fake
def _(x, w_exp, b_exp, w_dw, b_dw, w_proj, b_proj, stride, residual):
    b, h, w, _ = x.shape
    return x.new_empty((b, h // stride, w // stride, w_proj.shape[1]))


def _add_layernorm_via_op(y, r, gamma, beta, out_dtype):
    outs = _add_layernorm(y, r, gamma, beta, out_dtype)
    return outs[0], outs[-1]


def _linear_via_op(x, w, b, act: str = "none", out_f32: bool = False):
    return _linear(x, w, b, act, out_f32)


def ir_block_via_op(x: torch.Tensor, blk: dict, *, stride: int, residual: bool) -> torch.Tensor:
    """``fused_ir_block``'s calling convention, through its operator."""
    return _ir_block(x, blk.get("w_exp"), blk.get("b_exp"), blk["w_dw"], blk["b_dw"],
                     blk["w_proj"], blk["b_proj"], stride, residual)


CUSTOM_OPS = SimpleNamespace(
    linear=_linear_via_op, add_layernorm=_add_layernorm_via_op,
    self_attention=_self_attention, cross_attention=_cross_attention,
    logsoftmax_topk=_logsoftmax_topk)
OP_NAMES = {decoder_linear: "fpn_mt::decoder_linear",
            decoder_add_layernorm: "fpn_mt::decoder_add_layernorm",
            decoder_self_attention: "fpn_mt::decoder_self_attention",
            decoder_cross_attention: "fpn_mt::decoder_cross_attention",
            decoder_logsoftmax_topk: "fpn_mt::decoder_logsoftmax_topk",
            fused_ir_block: "fpn_mt::fused_ir_block"}
