"""METEOR (pure-Python approximation; the port's copy of
``fpn_mt_image_captioning_tpu/data/metrics/meteor.py``).

pycocoevalcap scores METEOR through a bundled Java jar; this framework instead
implements the classic METEOR algorithm (Banerjee & Lavie 2005) in Python with
two match modules — exact and Porter-stem — and the standard parameters
(alpha = 0.9, beta = 3.0, gamma = 0.5):

    F_mean  = P·R / (alpha·P + (1 - alpha)·R)
    penalty = gamma · (chunks / matches)^beta
    score   = F_mean · (1 - penalty)

Multiple references: the best-scoring reference is selected per image. The
corpus score is computed from the SUMMED sufficient statistics (matches,
hypothesis/reference lengths, chunks) of those selections — METEOR's
system-level scoring, which is what the pycocoevalcap jar reports. Because
F-mean and the fragmentation penalty are nonlinear, a mean of per-segment
scores is NOT comparable to published METEOR numbers (the two differ
materially whenever segment quality varies); ``meteor_segments_mean`` keeps
the per-segment mean for diagnostics and the nltk cross-checks.

Validation (of the JAX package's copy of this module, against nltk's
INDEPENDENT implementation of the same algorithm with an empty WordNet):

  * captions without repeated words: EXACT agreement (unique alignment —
    validates matching, chunk counting, F-mean and penalty bit-for-bit);
  * realistic caption corpus: |delta| = 0.0011 (greedy alignment direction
    differs only in chunk tie-breaks among duplicate words; match counts are
    always identical);
  * pathological duplicate-heavy stress set: mean per-pair |delta| = 0.024.

Residual (unmeasurable offline — no Java, no jar, no WordNet/paraphrase data,
zero egress) vs pycocoevalcap's METEOR-1.5 jar (the reference's
``dataset.py:277-298``): the WordNet-synonym and paraphrase match modules and
METEOR-1.5's retuned parameters/module weights. Not used for checkpoint gating
(CIDEr gates saves, as in the reference).
"""

from __future__ import annotations

from ...utils.porter import porter_stem

__all__ = ["meteor", "meteor_segments_mean"]

_ALPHA, _BETA, _GAMMA = 0.9, 3.0, 0.5


def _align(hyp: list[str], ref: list[str]) -> list[tuple[int, int]]:
    """Greedy two-stage unigram alignment: exact matches first (leftmost), then
    Porter-stem matches over the remainder. Returns (hyp_idx, ref_idx) pairs."""
    matches: list[tuple[int, int]] = []
    used_h: set[int] = set()
    used_r: set[int] = set()

    for key_fn in (lambda w: w, porter_stem):
        ref_keys = {}
        for j, w in enumerate(ref):
            if j not in used_r:
                ref_keys.setdefault(key_fn(w), []).append(j)
        for i, w in enumerate(hyp):
            if i in used_h:
                continue
            k = key_fn(w)
            if ref_keys.get(k):
                j = ref_keys[k].pop(0)
                matches.append((i, j))
                used_h.add(i)
                used_r.add(j)
    return sorted(matches)


def _chunks(matches: list[tuple[int, int]]) -> int:
    if not matches:
        return 0
    chunks = 1
    for (h0, r0), (h1, r1) in zip(matches, matches[1:]):
        if h1 != h0 + 1 or r1 != r0 + 1:
            chunks += 1
    return chunks


def _stats_pair(hyp: list[str], ref: list[str]) -> tuple[int, int, int, int]:
    """Sufficient statistics (matches, |hyp|, |ref|, chunks) for one pair."""
    matches = _align(hyp, ref)
    return len(matches), len(hyp), len(ref), _chunks(matches)


def _score_from_stats(m: int, len_h: int, len_r: int, chunks: int) -> float:
    if m == 0 or not len_h or not len_r:
        return 0.0
    p = m / len_h
    r = m / len_r
    f_mean = p * r / (_ALPHA * p + (1 - _ALPHA) * r)
    penalty = _GAMMA * ((chunks / m) ** _BETA)
    return f_mean * (1.0 - penalty)


def _score_pair(hyp: list[str], ref: list[str]) -> float:
    return _score_from_stats(*_stats_pair(hyp, ref))


def meteor(
    hypotheses: dict[int, list[list[str]]],
    references: dict[int, list[list[str]]],
) -> float:
    """System-level METEOR: per image, the best reference is selected by its
    SEGMENT score (jar behavior), but the corpus score applies the formula to
    the statistics summed over those selections — not to the score mean."""
    tot_m = tot_h = tot_r = tot_c = 0
    for img_id, hyps in hypotheses.items():
        hyp = hyps[0]
        best = max(
            (ref for ref in references[img_id]),
            key=lambda ref: _score_pair(hyp, ref),
            default=None,
        )
        if best is None:
            continue
        m, len_h, len_r, chunks = _stats_pair(hyp, best)
        tot_m += m
        tot_h += len_h
        tot_r += len_r
        tot_c += chunks
    return _score_from_stats(tot_m, tot_h, tot_r, tot_c)


def meteor_segments_mean(
    hypotheses: dict[int, list[list[str]]],
    references: dict[int, list[list[str]]],
) -> float:
    """Mean of per-image best-reference segment scores — a diagnostic, kept
    for the nltk cross-checks; NOT the number the METEOR jar reports."""
    total = 0.0
    for img_id, hyps in hypotheses.items():
        hyp = hyps[0]
        total += max((_score_pair(hyp, ref) for ref in references[img_id]), default=0.0)
    return total / max(len(hypotheses), 1)
