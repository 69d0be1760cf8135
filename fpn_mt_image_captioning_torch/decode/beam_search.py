"""Batched KV-cached beam search, greedy decoding and sampling (port of
``fpn_mt_image_captioning_tpu/decode/beam_search.py``).

Two routes to a decode step:

* **fused** — ``ops/fused_decoder.py:fused_decode_step``, the hand-written
  kernels on the card; the step freezes finished beams and returns each
  row's top ``beam`` candidates. The self-attention caches are never
  gathered on a beam reorder: ``src_t`` (Lpad, B·beam) holds, per position,
  the group-local beam whose cache row carries each hypothesis' ancestry.
* **non-fused** — ``Transformer.init_cache``/``decode_step`` in plain
  PyTorch (what the JAX package runs through XLA): the encoder output tiled
  beam-major, caches of ``max_len + 1`` positions, and ``src`` (B·beam,
  max_len + 1) of **global** cache rows, re-indexed by the parents on every
  step and with column ``t + 1`` set to each row's own index.

Two scoring modes:

* **fast (default)** — beams start as ``[0, -1e9, …]`` so the first
  expansion diversifies from one hypothesis; finished beams are frozen
  (forced pad continuation at zero added score); the loop stops when every
  beam of every batch item has finished, or after ``max_len`` tokens. The
  result drops ``<start>`` and cuts at the first ``<end>``.
* **parity** (non-fused only) — the reference's quirks: all beams start at
  score 0 from identical states, so the first top-k breaks the tie toward
  the lowest flat index and every beam takes the same token (the search
  degenerates to greedy); finished beams are not frozen; ``finished`` is
  "the last token is ``<end>``" (not sticky); per item the result is latched
  the first time the best beam's last token is ``<end>``. Mid-sequence
  ``<end>``s stay in the result.

Every top-k here is a stable descending sort, so ties go to the lowest
index (``torch.topk`` promises no tie order).

``sample_decode`` draws tokens with temperature / top-k / nucleus
truncation on the non-fused step; ``sample_tokens`` is its token choice as
a pure function of the logits and the Gumbel noise. The loops run in
Python with one host sync per step (the stop test), or, with
``fixed_steps``, exactly ``max_len`` steps and no sync: what an exported
program runs (``export.py``). Fast mode freezes a finished beam at +0 with
pad, so frozen beams keep their order under the stable sort and the first
``<end>`` cuts the result: the steps after every beam has finished change
nothing, and both trip counts give the same result.

Each step of ``beam_search`` is a ``beam.step`` span (``utils.profiling``):
the stop test ``beam.sync``, then ``beam.issue``, the expansion and the
loop's bookkeeping, whose decode step is ``beam.kernels``. The stop test
that ends the loop early is a step of its own, without an issue.
"""

from __future__ import annotations

import torch

from ..models.positional import raw_positional_encoding
from ..ops.fused_decoder import (fused_decode_step, init_fused_cache, no_grad,
                                 pack_decoder_weights)
from ..utils.profiling import annotate
from .noise import gumbel

__all__ = ["beam_search", "greedy_decode", "sample_decode", "sample_tokens",
           "strip_sequence", "cast_for_inference", "NEG_INF"]

NEG_INF = -1.0e9


def _top(flat: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` of each row, descending, ties to the lowest index."""
    order = torch.sort(flat, dim=1, descending=True, stable=True).indices[:, :k]
    return flat.gather(1, order), order


def _nucleus_keep(probs: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Nucleus (top-p) keep-mask: the smallest prefix of the descending-prob
    order whose mass reaches ``top_p`` (the top token always survives).

    By position, scattered back through the order, so a token tied with the
    boundary probability is not kept with it. The order reverses a stable
    ascending sort, as JAX's ``argsort(probs)[:, ::-1]``: among equal
    probabilities the higher index comes first. ``top_p`` is clamped at
    1e-9, so ``top_p <= 0`` keeps the top token alone."""
    order = torch.argsort(probs, dim=-1, stable=True).flip(-1)
    sorted_probs = probs.gather(-1, order)
    csum = sorted_probs.cumsum(-1)
    keep_sorted = (csum - sorted_probs) < top_p.clamp(min=1e-9)[:, None]
    return torch.zeros_like(probs, dtype=torch.bool).scatter(-1, order, keep_sorted)


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
    from ..models.layers import BatchNorm32

    norms = (torch.nn.LayerNorm, BatchNorm32)
    for m in model.modules():
        if isinstance(m, norms):
            continue
        for name, p in m.named_parameters(recurse=False):
            if p.is_floating_point():
                p.data = p.data.to(dtype)
    return model


def _fused_expand(model, enc_output, beam_n: int, max_len: int, packed):
    """The fused route's expansion: ``expand(tokens, t, scores, finished)``
    → (new scores, parent beams, new tokens), each (B, beam), with the
    ancestry remapped for the next step."""
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

    def expand(tokens, t, scores, finished):
        nonlocal src_t
        x_emb = emb_table[tokens] + pe_table[t]
        with annotate("beam.kernels"):
            top_s, top_i, _ = fused_decode_step(
                packed, cache, x_emb, src_t, t,
                scores.reshape(bk, 1), finished.reshape(bk, 1).float(),
                num_layers=model.num_layers, beam=beam_n, num_heads=model.num_heads,
                topk=beam_n, activation=model.activation,
            )
        # candidates are beam-major, each beam's descending with ids ascending on
        # ties, so a STABLE sort breaks ties exactly as the full (B, K·V) top-k
        new_scores, order = _top(top_s.reshape(batch, beam_n * beam_n), beam_n)
        beam_idx = order // beam_n
        new_tokens = top_i.reshape(batch, beam_n * beam_n).gather(1, order)
        # lazy reorder: remap the ancestry instead of gathering the caches,
        # and make the next position each row's own (the step's contract)
        src_t = src_t[:, (group_base + beam_idx).reshape(-1)]
        src_t[t + 1] = own_local
        return new_scores, beam_idx, new_tokens

    return expand


def _cached_expand(model, enc_output, beam_n: int, max_len: int, parity: bool):
    """The non-fused route's expansion (same contract as ``_fused_expand``):
    ``Transformer.decode_step``, log-softmax in float32, the freeze of
    finished beams in fast mode, the running score added, the flat (B, K·V)
    top-k."""
    dev = enc_output.device
    batch = enc_output.shape[0]
    bk = batch * beam_n
    cache = model.init_cache(enc_output.repeat_interleave(beam_n, dim=0), max_len + 1)
    own_rows = torch.arange(bk, device=dev)
    src = own_rows[:, None].repeat(1, max_len + 1)            # (BK, max_len + 1)
    group_base = torch.arange(batch, device=dev)[:, None] * beam_n

    def expand(tokens, t, scores, finished):
        nonlocal src
        with annotate("beam.kernels"):
            logits, _ = model.decode_step(tokens, t, cache, src)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        vocab = log_probs.shape[-1]
        log_probs = log_probs.reshape(batch, beam_n, vocab)
        if not parity:
            # freeze finished beams: only pad (id 0) continues, at zero added score
            pad_row = torch.full((vocab,), NEG_INF, device=dev)
            pad_row[0] = 0.0
            log_probs = torch.where(finished[..., None], pad_row, log_probs)
        total = scores[..., None] + log_probs
        new_scores, flat_idx = _top(total.reshape(batch, beam_n * vocab), beam_n)
        beam_idx = flat_idx // vocab
        src = src[(group_base + beam_idx).reshape(-1)]
        src[:, t + 1] = own_rows
        return new_scores, beam_idx, flat_idx % vocab

    return expand


@no_grad
def beam_search(
    model,
    enc_output: torch.Tensor,    # (B, Lenc, d_model)
    *,
    beam_n: int,
    max_len: int,                # maximum generated tokens (incl. <end>), == max_seq_len
    start_token: int,
    end_token: int,
    parity: bool = False,
    fused: bool = False,         # the fused decode step (hand-written kernels on the card)
    packed: dict | None = None,  # fused: pack_decoder_weights(model, dtype); packed here if None
    fixed_steps: bool = False,   # run all max_len steps; never read the stop flag on the host
):
    """Returns ``(sequences (B, max_len) int32, lengths (B,) int32, scores (B,))``
    — the best beam per batch item, ``<start>``/``<end>`` stripped, pad 0
    beyond ``lengths``."""
    if parity and fused:
        raise ValueError(
            "parity mode requires the non-fused decode path (the fused step "
            "freezes finished beams; the reference does not freeze)")
    dev = enc_output.device
    batch = enc_output.shape[0]
    expand = (_fused_expand(model, enc_output, beam_n, max_len, packed) if fused
              else _cached_expand(model, enc_output, beam_n, max_len, parity))

    scores = torch.zeros((batch, beam_n), device=dev)
    if not parity:
        scores[:, 1:] = NEG_INF
    seqs = torch.zeros((batch, beam_n, max_len), dtype=torch.int32, device=dev)
    tokens = torch.full((batch * beam_n,), start_token, dtype=torch.long, device=dev)
    finished = torch.zeros((batch, beam_n), dtype=torch.bool, device=dev)
    # parity mode: per item, the result latched the first time its best
    # beam's last token is <end> (the reference's early return)
    done = torch.zeros((batch,), dtype=torch.bool, device=dev)
    res_seq = torch.zeros((batch, max_len), dtype=torch.int32, device=dev)
    res_len = torch.zeros((batch,), dtype=torch.int32, device=dev)
    res_score = torch.zeros((batch,), device=dev)
    idx = torch.arange(max_len, device=dev)[None, :]

    t = 0
    while t < max_len:
        # a step: the stop test (the loop's one host sync), then the expansion
        # and the bookkeeping that issue the step's work
        with annotate("beam.step"):
            if not fixed_steps:
                with annotate("beam.sync", wait=True):
                    stop = bool((done if parity else finished).all())
                if stop:
                    break
            with annotate("beam.issue"):
                new_scores, beam_idx, new_tokens = expand(tokens, t, scores, finished)
                seqs = seqs.gather(1, beam_idx[..., None].expand(-1, -1, max_len))
                seqs[:, :, t] = new_tokens.to(torch.int32)
                if parity:
                    finished = new_tokens == end_token
                    newly = finished[:, 0] & ~done
                    cand = torch.where(idx < t, seqs[:, 0, :], 0)   # the trailing <end> dropped
                    res_seq = torch.where(newly[:, None], cand, res_seq)
                    res_len = torch.where(newly, t, res_len)
                    res_score = torch.where(newly, new_scores[:, 0], res_score)
                    done |= newly
                else:
                    finished = finished.gather(1, beam_idx) | (new_tokens == end_token)
                scores = new_scores
                tokens = new_tokens.reshape(-1).long()
        t += 1

    best_seq, best_score = seqs[:, 0, :], scores[:, 0]
    if parity:
        # items never latched return all t tokens, mid-sequence <end>s kept
        tail = torch.where(idx < t, best_seq, 0)
        return (torch.where(done[:, None], res_seq, tail),
                torch.where(done, res_len, t).to(torch.int32),
                torch.where(done, res_score, best_score))
    stripped, lengths = _strip_ended(best_seq, t, end_token)
    return stripped, lengths, best_score


def greedy_decode(model, enc_output: torch.Tensor, *, max_len: int, start_token: int,
                  end_token: int):
    """Greedy argmax decode (beam 1, fast mode, non-fused) — (B, max_len)
    stripped sequences and lengths."""
    seqs, lengths, _ = beam_search(model, enc_output, beam_n=1, max_len=max_len,
                                   start_token=start_token, end_token=end_token)
    return seqs, lengths


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor, top_k: int,
                  top_p: torch.Tensor | None, noise: torch.Tensor) -> torch.Tensor:
    """The sampled token of each row: ``argmax(masked logits + noise)``, which
    is a categorical draw when ``noise`` is standard Gumbel (as
    ``jax.random.categorical``). ``logits`` (B, V) are divided by
    ``temperature`` (B,) clamped at 1e-6; with ``top_k`` (0 = off) every
    logit below the k-th largest value is masked (ties with it stay); with
    ``top_p`` (B,) the nucleus (``_nucleus_keep``); masked logits are -1e9."""
    logits = logits.float() / temperature.clamp(min=1e-6)[:, None]
    if top_k and top_k < logits.shape[-1]:
        kth = logits.topk(top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p is not None:
        keep = _nucleus_keep(torch.softmax(logits, dim=-1), top_p)
        logits = torch.where(keep, logits, NEG_INF)
    return (logits + noise).argmax(dim=-1)


@no_grad
def sample_decode(
    model,
    enc_output: torch.Tensor,        # (B, Lenc, d_model)
    generator: torch.Generator | None,  # on enc_output's device; the noise of every step
    *,
    max_len: int,
    start_token: int,
    end_token: int,
    temperature=1.0,                 # scalar or (B,)
    top_k: int = 0,                  # 0 = no top-k truncation
    top_p=None,                      # scalar or (B,); None omits the nucleus sort
    noise: torch.Tensor | None = None,  # (max_len, B, V) Gumbel noise in place of generator's
    fixed_steps: bool = False,       # run all max_len steps; never read the stop flag on the host
    rows: tuple[int, int] | None = None,  # (first row, global rows): this rank's share
):
    """Ancestral sampling on the non-fused decode step, with the stripped
    return contract of ``beam_search``: (seqs (B, max_len) int32, lengths).
    A finished row emits pad (0); the loop stops when every row has
    finished (unless ``fixed_steps``), or after ``max_len`` tokens. Step
    ``t`` draws its noise from ``generator`` (``decode.noise.gumbel``; with
    ``rows``, the global batch's noise and this rank's rows of it), or
    takes ``noise[t]``."""
    dev = enc_output.device
    batch = enc_output.shape[0]
    temperature = torch.as_tensor(temperature, dtype=torch.float32, device=dev).expand(batch)
    if top_p is not None:
        top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev).expand(batch)
    cache = model.init_cache(enc_output, max_len + 1)
    seqs = torch.zeros((batch, max_len), dtype=torch.int32, device=dev)
    tokens = torch.full((batch,), start_token, dtype=torch.long, device=dev)
    finished = torch.zeros((batch,), dtype=torch.bool, device=dev)
    t = 0
    while t < max_len and (fixed_steps or not bool(finished.all())):
        logits, _ = model.decode_step(tokens, t, cache)      # no reorder: no ancestry
        step_noise = gumbel(generator, logits.shape, dev, rows) if noise is None else noise[t]
        tokens = sample_tokens(logits, temperature, top_k, top_p, step_noise)
        tokens = torch.where(finished, 0, tokens)
        seqs[:, t] = tokens.to(torch.int32)
        finished |= tokens == end_token
        t += 1
    return _strip_ended(seqs, t, end_token)


def strip_sequence(tokens, end_token: int) -> list[int]:
    """Host-side helper of the reference's return contract: ``tokens``
    exclude ``<start>``; cut at ``<end>``, pads dropped."""
    out = []
    for t in list(tokens):
        t = int(t)
        if t == end_token:
            break
        if t != 0:
            out.append(t)
    return out
