"""Plain float32 decoding: the log-probabilities of a caption given its
image, and beam search by full recomputation (no cache), each step's parents
kept so that the ancestry the search gathers can be counted."""

from __future__ import annotations

import torch

NEG_INF = -1.0e9


@torch.no_grad()
def token_log_probs(model, enc: torch.Tensor, seqs: torch.Tensor, start: int) -> torch.Tensor:
    """(B, L, V) float32 log-probabilities of each next token, teacher-forced
    on ``<start>`` followed by ``seqs[:, :L-1]`` (B, L)."""
    inp = torch.cat([torch.full_like(seqs[:, :1], start), seqs[:, :-1]], 1).long()
    return torch.log_softmax(model.logits(enc, inp).float(), -1)


@torch.no_grad()
def beam_search(model, enc: torch.Tensor, beam: int, max_len: int, start: int, end: int):
    """Beam search as the captioner runs it: beams start at ``[0, −1e9, …]``,
    a finished beam continues with pad (0) at no cost, the flat top ``beam``
    of each item's ``beam × V`` candidates by a stable sort, all ``max_len``
    steps. Returns ``(seqs (B, beam, max_len) best first, scores (B, beam),
    parents (max_len, B, beam))``."""
    b = enc.shape[0]
    dev = enc.device
    enc_rows = enc.repeat_interleave(beam, 0)
    scores = torch.full((b, beam), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    seqs = torch.zeros((b, beam, 0), dtype=torch.long, device=dev)
    finished = torch.zeros((b, beam), dtype=torch.bool, device=dev)
    parents = []
    for _ in range(max_len):
        inp = torch.cat([torch.full((b * beam, 1), start, device=dev),
                         seqs.reshape(b * beam, -1)], 1)
        lp = torch.log_softmax(model.logits(enc_rows, inp)[:, -1].float(), -1)
        v = lp.shape[-1]
        lp = lp.reshape(b, beam, v)
        pad_row = torch.full((v,), NEG_INF, device=dev)
        pad_row[0] = 0.0
        lp = torch.where(finished[..., None], pad_row, lp)
        total = (scores[..., None] + lp).reshape(b, beam * v)
        order = torch.sort(total, dim=1, descending=True, stable=True).indices[:, :beam]
        scores, parent, token = total.gather(1, order), order // v, order % v
        seqs = torch.cat([seqs.gather(1, parent[..., None].expand(-1, -1, seqs.shape[2])),
                          token[..., None]], 2)
        finished = finished.gather(1, parent) | (token == end)
        parents.append(parent)
    return seqs, scores, torch.stack(parents)


def distinct_ancestors(parents: torch.Tensor) -> list[float]:
    """For each step t (0-based), the mean over items of the number of
    distinct (position, beam) cache rows that the beams alive at step t read
    over positions 0..t: each beam reads its own row at t and its ancestors'
    at earlier positions. ``parents`` (T, B, K)."""
    steps, b, k = parents.shape
    out = []
    for t in range(steps):
        rows = float(k)                                # position t: each beam's own row
        who = parents[t - 1] if t else None            # beams at step t from step t - 1's
        for p in range(t - 1, -1, -1):
            rows += sum(len(set(r)) for r in who.tolist()) / b
            if p:
                who = parents[p - 1].gather(1, who)
        out.append(rows)
    return out
