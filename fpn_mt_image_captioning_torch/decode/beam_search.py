"""Batched KV-cached beam search on the fused decode step (port of the fast,
fused route of ``fpn_mt_image_captioning_tpu/decode/beam_search.py``).

Fast mode: beams start as ``[0, -1e9, …]`` so the first expansion diversifies
from one hypothesis; finished beams are frozen (forced pad continuation at
zero added score, inside the decode step); the loop stops when every beam of
every batch item has finished, or after ``max_len`` tokens. The result drops
``<start>`` and cuts at the first ``<end>``.

The self-attention caches are never gathered on a beam reorder: ``src_t``
(Lpad, B·beam) holds, per position, the group-local beam whose cache row
carries each hypothesis' ancestry, and the decode step reads through it.

The loop runs in Python with one host sync per step (the all-finished test).
Parity mode, greedy decoding and sampling are not ported yet.
"""

from __future__ import annotations

import torch

from ..models.positional import raw_positional_encoding
from ..ops.fused_decoder import fused_decode_step, init_fused_cache, pack_decoder_weights

__all__ = ["beam_search", "cast_for_inference", "NEG_INF"]

NEG_INF = -1.0e9


def _strip_ended(seqs: torch.Tensor, t: int, end_token: int):
    """Replace everything from the first ``<end>`` on with pad (0); lengths =
    the ``<end>`` position, or ``t`` for rows that never finished."""
    is_end = seqs == end_token
    ended = is_end.any(dim=1)
    end_pos = is_end.to(torch.int32).argmax(dim=1)          # first <end>
    idx = torch.arange(seqs.shape[1], device=seqs.device)[None, :]
    keep = torch.where(ended[:, None], idx < end_pos[:, None], idx < t)
    stripped = torch.where(keep, seqs, torch.zeros_like(seqs))
    lengths = torch.where(ended, end_pos, torch.full_like(end_pos, t)).to(torch.int32)
    return stripped, lengths


@torch.no_grad()
def cast_for_inference(model: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Cast the weights to the compute dtype once, in place — except the
    LayerNorm and BatchNorm parameters and statistics, which stay float32 (the
    norms compute in float32)."""
    from ..models.backbones.mobilenet_v2 import BatchNorm32

    norms = (torch.nn.LayerNorm, BatchNorm32)
    for m in model.modules():
        if isinstance(m, norms):
            continue
        for name, p in m.named_parameters(recurse=False):
            if p.is_floating_point():
                p.data = p.data.to(dtype)
    return model


@torch.no_grad()
def beam_search(
    model,
    enc_output: torch.Tensor,    # (B, Lenc, d_model)
    *,
    beam_n: int,
    max_len: int,                # maximum generated tokens (incl. <end>), == max_seq_len
    start_token: int,
    end_token: int,
    packed: dict | None = None,  # pack_decoder_weights(model, dtype); packed here if None
):
    """Returns ``(sequences (B, max_len) int32, lengths (B,) int32, scores (B,))``
    — the best beam per batch item, ``<start>``/``<end>`` stripped, pad 0
    beyond ``lengths``."""
    if packed is None:
        packed = pack_decoder_weights(model, enc_output.dtype)
    dev = enc_output.device
    batch = enc_output.shape[0]
    bk = batch * beam_n
    dtype = packed["wqkv"].dtype

    cache = init_fused_cache(packed, enc_output, beam_n, max_len)
    lpad = cache["k_self"].shape[1]
    emb_table = model.decoder.embedding.weight.to(dtype)
    pe_table = torch.as_tensor(
        raw_positional_encoding(model.max_seq_len + model.max_position, model.d_model),
        device=dev).to(dtype)
    own_local = (torch.arange(bk, device=dev) % beam_n).to(torch.int32)
    src_t = own_local[None, :].repeat(lpad, 1)                 # (Lpad, BK)
    group_base = torch.arange(batch, device=dev)[:, None] * beam_n

    scores = torch.full((batch, beam_n), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    seqs = torch.zeros((batch, beam_n, max_len), dtype=torch.int32, device=dev)
    tokens = torch.full((bk,), start_token, dtype=torch.long, device=dev)
    finished = torch.zeros((batch, beam_n), dtype=torch.bool, device=dev)

    t = 0
    while t < max_len and not bool(finished.all()):
        x_emb = emb_table[tokens] + pe_table[t]
        top_s, top_i, cache = fused_decode_step(
            packed, cache, x_emb, src_t, t,
            scores.reshape(bk, 1), finished.reshape(bk, 1).float(),
            num_layers=model.num_layers, beam=beam_n, num_heads=model.num_heads,
            topk=beam_n, activation=model.activation,
        )
        cand_s = top_s.reshape(batch, beam_n * beam_n)
        cand_i = top_i.reshape(batch, beam_n * beam_n)
        # candidates are beam-major, each beam's descending with ids ascending on
        # ties, so a STABLE sort breaks ties exactly as the full (B, K·V) top-k
        order = torch.sort(cand_s, dim=1, descending=True, stable=True).indices[:, :beam_n]
        new_scores = cand_s.gather(1, order)
        beam_idx = order // beam_n                                  # (B, K)
        new_tokens = cand_i.gather(1, order)

        # lazy reorder: remap the ancestry instead of gathering the caches,
        # and make the next position each row's own (the step's contract)
        src_t = src_t[:, (group_base + beam_idx).reshape(-1)]
        src_t[t + 1] = own_local
        seqs = seqs.gather(1, beam_idx[..., None].expand(-1, -1, max_len))
        seqs[:, :, t] = new_tokens
        finished = finished.gather(1, beam_idx) | (new_tokens == end_token)
        scores = new_scores
        tokens = new_tokens.reshape(-1).long()
        t += 1

    stripped, lengths = _strip_ended(seqs[:, 0, :], t, end_token)
    return stripped, lengths, scores[:, 0]
