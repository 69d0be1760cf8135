"""The sharded training state, step, encode and beam search (port of
``fpn_mt_image_captioning_tpu/parallel/train.py``).

``shard_state`` keeps, on each rank, its shard of every parameter that
``mesh.param_placements`` splits over the model axis (the Keras-Adam moments
follow their parameter; the BatchNorm statistics and the step stay whole)
and wires the modules to the mesh's groups: the attentions, FFNs, the K/V
stack and the final layer to the model group (``models/``), every BatchNorm
to the data group. ``make_sharded_train_step`` runs the single-process step
body (``train.pipeline.build_train_step_fn``) on this rank's data share with
the collectives of the mesh: the global loss denominator, the gradients
summed over the data group before the per-variable clip, the clip norms of
sharded variables summed over the model group. The sharded encode and beam
search run each rank's rows with whole weights and issue no collective (a
beam stops when its own rows have ended); a sharded model is gathered
whole once a call.
"""

from __future__ import annotations

import copy
from typing import Callable

import torch
from torch import nn

from ..decode.beam_search import beam_search
from ..models.attention import MultiHeadAttention, MultiViewAttention
from ..models.layers import BatchNorm32
from ..models.transformer import Encoder, Transformer, _FFN
from ..ops.fused_decoder import pack_decoder_weights
from ..train.pipeline import TrainState, build_train_step_fn
from .collectives import gather_shards
from .mesh import (axis_index, axis_size, data_group, data_rows, model_group,
                   param_placements)
from .multihost import globalize_batch

__all__ = ["state_shardings", "shard_state", "make_sharded_train_step",
           "make_sharded_decode_encode", "make_sharded_beam_search", "whole_state_dict",
           "whole_copy", "shard_tensor"]


def state_shardings(mesh, state: TrainState, tp: bool = True) -> dict:
    """``{parameter name: dimension split over the model axis, or None}``;
    the optimizer's moments follow their parameter, the statistics and
    counters are whole. ``state.model`` holds whole weights."""
    tp = tp and axis_size(mesh, 1) > 1
    return param_placements(mesh, state.model, tp)


def shard_tensor(t: torch.Tensor, dim, mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor ``t`` along ``dim`` (``t``
    itself where ``dim`` is None)."""
    if dim is None:
        return t
    n = t.shape[dim] // axis_size(mesh, 1)
    return t.narrow(dim, axis_index(mesh, 1) * n, n).clone()


def shard_state(mesh, state: TrainState, tp: bool = True) -> tuple[TrainState, dict]:
    """Keep this rank's shards of ``state`` (in place) and wire its model to
    the mesh. Returns ``(state, placements)``."""
    placements = state_shardings(mesh, state, tp)
    model = state.model
    params = list(model.parameters())
    dims = list(placements.values())
    with torch.no_grad():
        for p, dim in zip(params, dims):
            p.data = shard_tensor(p.data, dim, mesh)
    opt = state.opt_state
    moments = [[shard_tensor(t, dim, mesh) for t, dim in zip(ts, dims)]
               for ts in (opt.m, opt.v, opt.vhat)]
    opt = opt._replace(m=moments[0], v=moments[1], vhat=moments[2])
    wire(model, mesh, placements)
    return TrainState(model, opt, state.step), placements


def wire(model: Transformer, mesh, placements: dict) -> None:
    """Give each module of ``model`` the groups its shards need."""
    mg, dg = model_group(mesh), data_group(mesh)
    sharded = lambda name: placements.get(name) is not None
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, BatchNorm32):
            m.data_group = dg
        elif isinstance(m, MultiHeadAttention) and sharded(pre + "wq.weight"):
            m.tp_group = m.out.tp_group = mg
            m.out.tp_row = True
        elif isinstance(m, _FFN) and sharded(pre + "ffn1.weight"):
            m.tp_group = m.ffn2.tp_group = mg
            m.ffn2.tp_row = True
        elif isinstance(m, MultiViewAttention) and sharded(pre + "wq"):
            m.tp_group = mg
        elif isinstance(m, Encoder) and sharded(pre + "kv_proj"):
            m.kv_group = mg
    if sharded("final_layer.weight"):
        model.vocab_group = mg
    model.tp_mesh, model.tp_placements = mesh, placements


@torch.no_grad()
def whole_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """``model``'s state dict with every sharded parameter gathered whole
    (a collective of the model group: every rank of it calls this)."""
    placements = getattr(model, "tp_placements", None) or {}
    mg = model_group(getattr(model, "tp_mesh", None))
    out = {}
    for name, t in model.state_dict().items():
        dim = placements.get(name)
        out[name] = t if dim is None or mg is None else gather_shards(t, mg, dim)
    return out


def whole_copy(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with whole weights and no groups (``model``
    itself when nothing of it is sharded)."""
    placements = getattr(model, "tp_placements", None) or {}
    if not any(d is not None for d in placements.values()):
        return model
    state = whole_state_dict(model)
    groups = {id(g): None for m in model.modules()
              for g in (getattr(m, "tp_group", None), getattr(m, "kv_group", None),
                        getattr(m, "vocab_group", None), getattr(m, "data_group", None),
                        getattr(m, "tp_mesh", None)) if g is not None}
    copied = copy.deepcopy(model, memo=dict(groups))
    copied.tp_placements = {}
    with torch.no_grad():
        for name, p in copied.named_parameters():
            p.data = state[name].clone()
    return copied


def make_sharded_train_step(mesh, learning_rate, placements: dict, *, seed: int,
                            dropout_rate: float, clipnorm: float = 1.0) -> Callable:
    """The ``(state, img, caption_token) → (state, loss)`` step over the
    mesh: ``img``/``caption_token`` are this rank's rows; the rows of its
    model group make its data share (``multihost.globalize_batch``), whose
    place in the global batch sets the dropout masks' rows. The loss
    returned is the global batch's, on every rank."""
    step = build_train_step_fn(learning_rate, seed=seed, dropout_rate=dropout_rate,
                               clipnorm=clipnorm, data_group=data_group(mesh),
                               model_group=model_group(mesh),
                               sharded=[d is not None for d in placements.values()])

    def sharded_step(state: TrainState, img: torch.Tensor, caption_token: torch.Tensor):
        img = globalize_batch(mesh, img)
        caption_token = globalize_batch(mesh, caption_token)
        n_global = axis_size(mesh, 0) * img.shape[0]
        return step(state, img, caption_token, rows=(data_rows(mesh, n_global).start, n_global))

    return sharded_step


def make_sharded_decode_encode(mesh, model: Transformer) -> Callable:
    """The encoder forward of this rank's rows, with whole weights."""
    del mesh

    @torch.no_grad()
    def encode(images: torch.Tensor) -> torch.Tensor:
        return whole_copy(model).encode(images)

    return encode


def make_sharded_beam_search(mesh, model: Transformer, *, beam_n: int, max_len: int,
                             start_token: int, end_token: int, parity: bool = False,
                             fused: bool = True, pack_dtype: torch.dtype | None = None,
                             packed: dict | None = None) -> Callable:
    """Beam search of this rank's rows, ``run(enc) → (seqs, lengths,
    scores)`` of those rows: the whole engine (the fused decode kernels on
    the card) with whole weights. Beam search is batch-parallel, so the
    result equals the unsharded search's rows bitwise; it holds no
    collective, so each rank stops when its own beams have ended. A
    tensor-parallel ``model`` is gathered whole once a call; ``packed``
    (``pack_decoder_weights`` of ``model``) is reused where given."""
    del mesh

    def run(enc: torch.Tensor):
        whole = whole_copy(model)
        pk = packed
        if fused and pk is None:
            pk = pack_decoder_weights(whole, pack_dtype or next(whole.parameters()).dtype)
        return beam_search(whole, enc, beam_n=beam_n, max_len=max_len,
                           start_token=start_token, end_token=end_token, parity=parity,
                           fused=fused, packed=pk)

    return run
