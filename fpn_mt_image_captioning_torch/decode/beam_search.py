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

**CUDA graphs** (fused route): a step is one body (``_FusedBeams.step``:
the embedding and positional gathers, the decode step's launches, the
top-k, the ancestry remap and the bookkeeping). Where the caller passes
``packed`` weights, the encoder output lies on the card, nothing traces
(``torch.export``) and the batch shape was seen before, the body's work
is captured once per shape, one graph a position, into buffers held with
the packed weights (``StepGraphs``), and a step replays its graph; the
stop test then runs every ``STOP_EVERY`` steps, so the host runs that far
ahead of the card (the frozen beams make the later test give the same
result). Elsewhere the same body runs eagerly, with the stop test every
step. The result is the same, bit for bit, and never a view of a held
buffer. The kernel wrappers' ``.launches`` count what they issue: a
graph's capture counts its launches once, a replay none (the profiler's
trace sees the replayed kernels).

Each step of ``beam_search`` is a ``beam.step`` span (``utils.profiling``):
the stop test ``beam.sync`` where one is due, then ``beam.issue``, the
expansion and the loop's bookkeeping, whose decode step is
``beam.kernels``; on the graph route ``beam.kernels`` is the replay, which
is ``beam.replay`` too, and each captured graph is a ``beam.capture``. The
stop test that ends the loop early is a step of its own, without an issue.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import torch

from ..models.positional import raw_positional_encoding
from ..ops.fused_decoder import (fused_decode_step, init_fused_cache, no_grad,
                                 pack_decoder_weights)
from ..utils.profiling import annotate
from .noise import gumbel

__all__ = ["beam_search", "greedy_decode", "sample_decode", "sample_tokens",
           "strip_sequence", "cast_for_inference", "NEG_INF", "StepGraphs", "GRAPHS_KEY"]

NEG_INF = -1.0e9
STOP_EVERY = 8        # the graph route's steps between two stop tests
GRAPH_SHAPES = 4      # batch shapes one packed weight set remembers, seen or captured
GRAPHS_KEY = "step_graphs"   # where the packed weights hold their StepGraphs


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


def _extend(seqs: torch.Tensor, beam_idx: torch.Tensor, new_tokens: torch.Tensor, t: int):
    """The sequences (B, beam, max_len) reordered by their parent beams, with
    token ``t`` set."""
    seqs = seqs.gather(1, beam_idx[..., None].expand(-1, -1, seqs.shape[2]))
    seqs[:, :, t] = new_tokens.to(torch.int32)
    return seqs


def _tables(model, dtype: torch.dtype, dev: torch.device):
    """The token embedding and the positional-encoding table, in ``dtype``
    on ``dev``."""
    pe = raw_positional_encoding(model.max_seq_len + model.max_position, model.d_model)
    return (model.decoder.embedding.weight.to(dtype),
            torch.as_tensor(pe, device=dev).to(dtype))


class _FusedBeams:
    """The fused route's search: its state and one step's body.

    ``held``: every call and every step write the state in place, into
    buffers made once (what a step's CUDA graph reads and writes); else a
    step rebinds fresh tensors (what ``torch.export`` traces). Either way a
    step is the same work: ``x_emb`` (the embedding and positional
    gathers), the decode step, the stable top-k over each item's
    ``beam`` × ``beam`` candidates, the ancestry remapped instead of the
    caches gathered, and the sequences, ``finished``, scores and tokens."""

    def __init__(self, model, packed: dict, tables, enc_output: torch.Tensor, *, beam_n: int,
                 max_len: int, start_token: int, end_token: int, held: bool = False):
        # without the StepGraphs, which hold this search: no reference cycle, so
        # a repack's old graphs and buffers go when their packed weights do
        self.packed = {k: v for k, v in packed.items() if k != GRAPHS_KEY}
        self.model, (self.emb, self.pe) = model, tables
        self.beam, self.max_len, self.start, self.end = beam_n, max_len, start_token, end_token
        self.held, self.cache = held, None
        dev, self.batch = enc_output.device, enc_output.shape[0]
        bk = self.batch * beam_n
        self.own_local = (torch.arange(bk, device=dev) % beam_n).to(torch.int32)
        self.group_base = torch.arange(self.batch, device=dev)[:, None] * beam_n
        self.reset(enc_output)

    def reset(self, enc_output: torch.Tensor) -> None:
        """The state before the first step: the cross K/V of ``enc_output``,
        zero self caches, one live hypothesis an item."""
        b, k, dev = self.batch, self.beam, enc_output.device
        self.cache = init_fused_cache(self.packed, enc_output, k, self.max_len,
                                      out=self.cache if self.held else None)
        scores = torch.zeros((b, k), device=dev)
        scores[:, 1:] = NEG_INF
        lpad = self.cache["k_self"].shape[1]
        self._set(scores=scores,
                  seqs=torch.zeros((b, k, self.max_len), dtype=torch.int32, device=dev),
                  tokens=torch.full((b * k,), self.start, dtype=torch.long, device=dev),
                  finished=torch.zeros((b, k), dtype=torch.bool, device=dev),
                  src_t=self.own_local[None, :].repeat(lpad, 1))       # (Lpad, BK)

    def _set(self, **state: torch.Tensor) -> None:
        for name, value in state.items():
            buf = getattr(self, name, None) if self.held else None
            if buf is None:
                setattr(self, name, value)
            else:
                buf.copy_(value)

    @property
    def stop(self) -> torch.Tensor:
        return self.finished

    def step(self, t: int, span=annotate) -> None:
        """Step ``t``; ``span`` names its decode step ``beam.kernels``."""
        m, b, k = self.model, self.batch, self.beam
        x_emb = self.emb[self.tokens] + self.pe[t]
        with span("beam.kernels"):
            top_s, top_i, _ = fused_decode_step(
                self.packed, self.cache, x_emb, self.src_t, t, self.scores.reshape(b * k, 1),
                self.finished.reshape(b * k, 1).float(), num_layers=m.num_layers, beam=k,
                num_heads=m.num_heads, topk=k, activation=m.activation)
        # candidates are beam-major, each beam's descending with ids ascending on
        # ties, so a STABLE sort breaks ties exactly as the full (B, K·V) top-k
        new_scores, order = _top(top_s.reshape(b, k * k), k)
        beam_idx = order // k
        new_tokens = top_i.reshape(b, k * k).gather(1, order)
        # lazy reorder: remap the ancestry instead of gathering the caches,
        # and make the next position each row's own (the step's contract)
        src_t = self.src_t[:, (self.group_base + beam_idx).reshape(-1)]
        src_t[t + 1] = self.own_local
        self._set(src_t=src_t, seqs=_extend(self.seqs, beam_idx, new_tokens, t),
                  finished=self.finished.gather(1, beam_idx) | (new_tokens == self.end),
                  scores=new_scores, tokens=new_tokens.reshape(-1).long())

    def result(self, t: int):
        """The best beam of each item after ``t`` steps, in fresh tensors
        (never a view of a held buffer, which the next call overwrites)."""
        stripped, lengths = _strip_ended(self.seqs[:, 0, :], t, self.end)
        best = self.scores[:, 0]
        return stripped, lengths, best.clone() if self.held else best


class _CachedBeams:
    """The non-fused route's search (the interface of ``_FusedBeams``):
    ``Transformer.init_cache``/``decode_step``, log-softmax in float32, the
    freeze of finished beams in fast mode, the running score added, the flat
    (B, K·V) top-k; in parity mode the reference's latch."""

    def __init__(self, model, enc_output: torch.Tensor, *, beam_n: int, max_len: int,
                 start_token: int, end_token: int, parity: bool):
        dev, b = enc_output.device, enc_output.shape[0]
        bk = b * beam_n
        self.model, self.beam, self.end, self.parity = model, beam_n, end_token, parity
        self.cache = model.init_cache(enc_output.repeat_interleave(beam_n, dim=0), max_len + 1)
        self.own_rows = torch.arange(bk, device=dev)
        self.src = self.own_rows[:, None].repeat(1, max_len + 1)      # (BK, max_len + 1)
        self.group_base = torch.arange(b, device=dev)[:, None] * beam_n
        self.scores = torch.zeros((b, beam_n), device=dev)
        if not parity:
            self.scores[:, 1:] = NEG_INF
        self.seqs = torch.zeros((b, beam_n, max_len), dtype=torch.int32, device=dev)
        self.tokens = torch.full((bk,), start_token, dtype=torch.long, device=dev)
        self.finished = torch.zeros((b, beam_n), dtype=torch.bool, device=dev)
        # parity mode: per item, the result latched the first time its best
        # beam's last token is <end> (the reference's early return)
        self.done = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.res_seq = torch.zeros((b, max_len), dtype=torch.int32, device=dev)
        self.res_len = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.res_score = torch.zeros((b,), device=dev)
        self.idx = torch.arange(max_len, device=dev)[None, :]

    @property
    def stop(self) -> torch.Tensor:
        return self.done if self.parity else self.finished

    def step(self, t: int, span=annotate) -> None:
        b, k, dev = self.scores.shape[0], self.beam, self.scores.device
        with span("beam.kernels"):
            logits, _ = self.model.decode_step(self.tokens, t, self.cache, self.src)
        log_probs = torch.log_softmax(logits.float(), dim=-1)
        vocab = log_probs.shape[-1]
        log_probs = log_probs.reshape(b, k, vocab)
        if not self.parity:
            # freeze finished beams: only pad (id 0) continues, at zero added score
            pad_row = torch.full((vocab,), NEG_INF, device=dev)
            pad_row[0] = 0.0
            log_probs = torch.where(self.finished[..., None], pad_row, log_probs)
        total = self.scores[..., None] + log_probs
        new_scores, flat_idx = _top(total.reshape(b, k * vocab), k)
        beam_idx = flat_idx // vocab
        self.src = self.src[(self.group_base + beam_idx).reshape(-1)]
        self.src[:, t + 1] = self.own_rows
        new_tokens = flat_idx % vocab
        self.seqs = _extend(self.seqs, beam_idx, new_tokens, t)
        if self.parity:
            self.finished = new_tokens == self.end
            newly = self.finished[:, 0] & ~self.done
            cand = torch.where(self.idx < t, self.seqs[:, 0, :], 0)  # the trailing <end> dropped
            self.res_seq = torch.where(newly[:, None], cand, self.res_seq)
            self.res_len = torch.where(newly, t, self.res_len)
            self.res_score = torch.where(newly, new_scores[:, 0], self.res_score)
            self.done |= newly
        else:
            self.finished = self.finished.gather(1, beam_idx) | (new_tokens == self.end)
        self.scores = new_scores
        self.tokens = new_tokens.reshape(-1).long()

    def result(self, t: int):
        best_seq, best_score = self.seqs[:, 0, :], self.scores[:, 0]
        if self.parity:
            # items never latched return all t tokens, mid-sequence <end>s kept
            done, tail = self.done, torch.where(self.idx < t, best_seq, 0)
            return (torch.where(done[:, None], self.res_seq, tail),
                    torch.where(done, self.res_len, t).to(torch.int32),
                    torch.where(done, self.res_score, best_score))
        stripped, lengths = _strip_ended(best_seq, t, self.end)
        return stripped, lengths, best_score


def _run_steps(search, max_len: int, fixed_steps: bool, issue=None, every: int = 1) -> int:
    """Run the search's steps; returns how many ran. Each is a ``beam.step``
    span: the stop test ``beam.sync`` where one is due, then ``beam.issue``,
    ``issue(t)`` (default ``search.step``). The stop test, the loop's one
    host sync, comes before every step (``every`` 1), or before steps
    ``every``, 2 ``every``, …, so that the host runs up to ``every`` steps
    ahead of the card; none with ``fixed_steps``. The stop test that ends the
    loop is a step of its own, without an issue."""
    issue = issue or search.step
    t = 0
    while t < max_len:
        with annotate("beam.step"):
            if not fixed_steps and t % every == 0 and (t or every == 1):
                with annotate("beam.sync", wait=True):
                    stop = bool(search.stop.all())
                if stop:
                    break
            with annotate("beam.issue"):
                issue(t)
        t += 1
    return t


def _no_span(name: str):
    return contextlib.nullcontext()


class _Captured:
    """One batch shape's held search and its CUDA graphs, one a position
    ``t`` (``pos`` is a scalar argument of the self-attention kernel), all
    captured in order into one private memory pool and replayed in that
    order."""

    def __init__(self, search: _FusedBeams):
        self.search, self.lock, self.done = search, threading.Lock(), None
        self.graphs = []
        with self._capturing():
            for t in range(search.max_len):
                with annotate("beam.capture"):
                    self.graphs.append(self._capture(t))

    @contextlib.contextmanager
    def _capturing(self):
        """A side stream to capture on (the default stream cannot be), and
        the graphs' one memory pool."""
        self.pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(torch.cuda.Stream(self.search.own_local.device)):
            yield

    def _capture(self, t: int):
        """Step ``t``'s graph (nothing runs while it is captured)."""
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            self.search.step(t, span=_no_span)
        finally:
            graph.capture_end()
        return graph

    def replay(self, t: int) -> None:
        with annotate("beam.kernels"), annotate("beam.replay"):
            self.graphs[t].replay()

    def run(self, enc_output: torch.Tensor, fixed_steps: bool):
        """A call: the held state reset from ``enc_output``, then the graphs
        replayed, the stop test every ``STOP_EVERY`` steps."""
        search = self.search
        with self._ordered():
            search.reset(enc_output)
            t = _run_steps(search, search.max_len, fixed_steps, issue=self.replay,
                           every=STOP_EVERY)
            return search.result(t)

    @contextlib.contextmanager
    def _ordered(self):
        """Order a call after the last one's reads of the held buffers,
        should it have run on another stream."""
        stream = torch.cuda.current_stream(self.search.own_local.device)
        if self.done is not None:
            stream.wait_event(self.done)
        yield
        self.done = stream.record_event()


_CAPTURING = "capturing"   # a shape whose graphs another thread is capturing


class StepGraphs:
    """What a packed weight set keeps for the fused beam search
    (``packed[GRAPHS_KEY]``, so a repack or a weight reload drops it): the
    embedding and positional-encoding tables on each device, cast once, and
    the last ``GRAPH_SHAPES`` batch shapes called, the least recently used
    out first: of each, whether it was seen once, is being captured, or its
    captured graphs. A shape's first call runs eagerly and its second
    captures, unless ``GRAPH_SHAPES`` other shapes came in between: a shape
    that rare never captures."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tables = {}
        self._shapes = collections.OrderedDict()   # key -> None (seen), _CAPTURING or _Captured

    def tables(self, model, dtype: torch.dtype, dev: torch.device):
        with self._lock:
            if (dtype, dev) not in self._tables:
                self._tables[dtype, dev] = _tables(model, dtype, dev)
            return self._tables[dtype, dev]

    def captured(self, key, make) -> _Captured | None:
        """The graphs of ``key`` with their lock taken, made by ``make()`` on
        the shape's second call, outside this set's lock (other calls run
        eagerly meanwhile); or None: a first call, or graphs being captured
        or in use by another thread."""
        with self._lock:
            seen = key in self._shapes
            entry = self._shapes.pop(key, None)
            self._shapes[key] = _CAPTURING if seen and entry is None else entry
            while len(self._shapes) > GRAPH_SHAPES:
                self._shapes.popitem(last=False)
        if not seen or entry is _CAPTURING:
            return None
        if entry is not None:
            return entry if entry.lock.acquire(blocking=False) else None
        try:
            entry = make()
        except BaseException:
            self._settle(key, None)
            raise
        entry.lock.acquire()
        self._settle(key, entry)
        return entry

    def _settle(self, key, entry) -> None:
        """The end of ``key``'s capture: its graphs, or None (seen) if it
        failed; nothing if the shape was pushed out meanwhile."""
        with self._lock:
            if self._shapes.get(key, entry) is _CAPTURING:
                self._shapes[key] = entry


def _fused_search(model, enc_output, *, packed, fixed_steps: bool, **kw):
    """The fused route. Its steps replay CUDA graphs where the call can keep
    them: the encoder output on the card, the caller's ``packed`` weights
    (which outlive the call and hold the graphs), no ``torch.export`` or
    ``torch.compile`` tracing, and a batch shape seen before. Otherwise, and
    on a shape's first call, the same step body runs eagerly (and
    ``torch.export`` traces it)."""
    dev, max_len = enc_output.device, kw["max_len"]
    held = packed is not None and not torch.compiler.is_compiling()
    if packed is None:
        packed = pack_decoder_weights(model, enc_output.dtype)
    dtype = packed["wqkv"].dtype
    tables = entry = None
    if held:
        graphs = packed.setdefault(GRAPHS_KEY, StepGraphs())
        tables = graphs.tables(model, dtype, dev)
        if enc_output.is_cuda:
            key = (*enc_output.shape[:2], kw["beam_n"], max_len, kw["end_token"], dtype, dev)
            entry = graphs.captured(key, lambda: _Captured(
                _FusedBeams(model, packed, tables, enc_output, held=True, **kw)))
    if entry is None:
        search = _FusedBeams(model, packed, tables or _tables(model, dtype, dev), enc_output,
                             **kw)
        return search.result(_run_steps(search, max_len, fixed_steps))
    try:
        return entry.run(enc_output, fixed_steps)
    finally:
        entry.lock.release()


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
    kw = dict(beam_n=beam_n, max_len=max_len, start_token=start_token, end_token=end_token)
    if fused:
        return _fused_search(model, enc_output, packed=packed, fixed_steps=fixed_steps, **kw)
    search = _CachedBeams(model, enc_output, parity=parity, **kw)
    return search.result(_run_steps(search, max_len, fixed_steps))


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
