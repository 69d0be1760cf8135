"""How ``correct`` is decided: the numbers that hold what the captioner
produced in a run to the plain float32 reference, each beside its limit.

Captioning: for a sample of the images a run captioned, drawn from the seed,
every number is taken from what the timed calls returned: the encoder
output that ``Pipeline.encode`` gave ``predict_batch``, and the caption and
its beam score that the beam search gave it. The reference decodes from the
captioner's own encoder output, so the decode numbers hold the decode steps
alone and ``enc_gap`` holds the encode alone.

* ``enc_gap``: by the worst image, ‖encoder output − the reference's
  encode of the image‖ over ‖the reference's‖.
* ``score_err``: by the worst image, the gap between the served caption's
  beam score (its summed log-probability as the captioner's decode steps
  computed it) and the log-probability of the same tokens under the
  reference's decoder, per token, in nats.
* ``beam_gap``: by the worst image, how far the served caption's
  log-probability under the reference lies below the best beam of the
  reference's own beam search, per token, in nats (0 where it lies above).
  This one sees the search's choices: a step that picks other candidates
  than its best, each with its true score, passes the other two.

Training: the losses of the first three steps, the gradient of the first
as the optimizer received it, and the parameters' change after three; and
one step after the window, which the reference takes from the captioner's
state before it (its parameters and Adam moments: the reference cannot
reach them by itself without replaying every step of the window).

* ``loss_gap``: the largest relative gap of a step's loss.
* ``grad_gap``, ``change_gap``: by the median leaf, the gap between the
  captioner's norm and the reference's, over the reference's norm of that
  leaf or of the median leaf, whichever is larger. The worst leaf's gradient
  gap (``grad_worst_gap``) is not compared: it is a backbone BatchNorm leaf
  whose gradient is a sum that cancels, and reads as high under a lower
  precision of the reference itself. All leave out the leaves whose
  reference gradient is under a thousandth of the median leaf's: their
  gradient is nought to rounding, and they move by round-off alone.
* ``leaf_change_gap``: by the worst leaf, |captioner's change − the
  reference's| over the reference's change of that leaf: a leaf left
  unmoved, or moved twice, reads 1.
* ``window_loss_gap``, ``window_change_gap``, ``window_leaf_gap``: the
  step after the window, as ``loss_gap``, ``change_gap`` and
  ``leaf_change_gap``.
"""

from __future__ import annotations

import statistics

import torch

from .reference import decode as ref_decode

# a leaf whose first reference gradient is under this share of the median
# leaf's moves by round-off alone (a key's bias under softmax)
ZERO_GRADIENT = 1e-3


def served_tokens(seqs: torch.Tensor, lengths: torch.Tensor, max_len: int, end: int):
    """The tokens the search chose: the served ones, then ``<end>`` where a
    caption ended (the captioner strips it). Returns (tokens, mask of the
    positions that count)."""
    toks = seqs.clone().long()
    pos = torch.arange(max_len, device=seqs.device)[None, :]
    ended = lengths < max_len
    rows = ended.nonzero()[:, 0]
    toks[rows, lengths[rows].long()] = end
    return toks, pos <= torch.where(ended, lengths, max_len - 1)[:, None]


@torch.no_grad()
def caption_numbers(model, images: torch.Tensor, enc: torch.Tensor, seqs: torch.Tensor,
                    lengths: torch.Tensor, scores: torch.Tensor, *, beam: int, max_len: int,
                    start: int, end: int, block: int = 16) -> tuple[dict, list[float]]:
    """``enc_gap``, ``score_err`` and ``beam_gap`` of the served encoder
    outputs ``enc`` (N, Lenc, d), captions ``seqs`` (N, L) with ``lengths``
    and beam ``scores`` (N,) of ``images`` (N, S, S, 3) uint8, under
    ``model`` (the float32 reference), in blocks of ``block`` images; and
    the mean self-attention cache rows that the reference's beam search
    reads at each step (``decode.distinct_ancestors``)."""
    enc_gap, score_err, beam_gap, parents = 0.0, 0.0, 0.0, []
    for i in range(0, images.shape[0], block):
        sl = slice(i, i + block)
        ref_enc = model.encode(images[sl])
        gap = (enc[sl].float() - ref_enc).flatten(1).norm(dim=1) / ref_enc.flatten(1).norm(dim=1)
        enc_gap = max(enc_gap, float(gap.max()))
        toks, keep = served_tokens(seqs[sl], lengths[sl], max_len, end)
        lp = ref_decode.token_log_probs(model, enc[sl].float(), toks, start)
        ref_score = (lp.gather(-1, toks[..., None])[..., 0] * keep).sum(-1)
        n = keep.sum(-1)
        score_err = max(score_err, float(((scores[sl].float() - ref_score).abs() / n).max()))
        _, best, par = ref_decode.beam_search(model, enc[sl].float(), beam, max_len, start, end)
        beam_gap = max(beam_gap, float(((best[:, 0] - ref_score).clamp(min=0) / n).max()))
        parents.append(par)
    return ({"enc_gap": enc_gap, "score_err": score_err, "beam_gap": beam_gap},
            ref_decode.distinct_ancestors(torch.cat(parents, 1)))


def _gaps(prog: dict, ref: dict, keys) -> dict:
    """Of each of ``keys``: |prog − ref| / max(ref, median of ref)."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def _moving(grad: dict) -> list[str]:
    med = statistics.median(grad.values())
    return [k for k, g in grad.items() if g >= ZERO_GRADIENT * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold ``losses`` (three), ``grad`` and
    ``change`` ({leaf: norm}) of the first three steps."""
    moving = _moving(ref["grad"])
    out = {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))}
    for key in ("grad", "change"):
        gaps = _gaps(prog[key], ref[key], moving)
        worst = max(gaps, key=gaps.get)
        out.update({f"{key}_gap": statistics.median(gaps.values()),
                    f"{key}_worst_gap": gaps[worst], f"{key}_worst": worst})
    leaf, worst = _own_gaps(prog["change"], ref["change"], moving)
    out.update(leaf_change_gap=leaf, leaf_change_worst=worst)
    return out


def _own_gaps(prog: dict, ref: dict, keys) -> tuple[float, str]:
    """The worst of ``keys`` by |prog − ref| / ref, and its name."""
    own = {k: abs(prog[k] - ref[k]) / max(ref[k], 1e-30) for k in keys}
    worst = max(own, key=own.get)
    return own[worst], worst


def window_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref`` each hold the ``loss`` and ``change`` ({leaf:
    norm}) of the step after the window, ``ref`` also its ``grad``."""
    moving = _moving(ref["grad"])
    gaps = _gaps(prog["change"], ref["change"], moving)
    leaf, worst = _own_gaps(prog["change"], ref["change"], moving)
    return {"window_loss_gap": abs(prog["loss"] - ref["loss"]) / abs(ref["loss"]),
            "window_change_gap": statistics.median(gaps.values()),
            "window_leaf_gap": leaf, "window_leaf_worst": worst}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every one is
    finite and at most its limit, and a number of each limit was read."""
    checks = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    ok = all(isinstance(c["value"], float) and c["value"] == c["value"]
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
