"""Corpus BLEU-1..4 with closest-reference-length brevity penalty.

Pure-Python equivalent of pycocoevalcap's BLEU scorer (corpus aggregation,
"closest" length option): per-image clipped n-gram counts are accumulated over
the corpus, precisions multiplied geometrically, brevity penalty computed from
the summed closest reference lengths.

The port's copy of ``fpn_mt_image_captioning_tpu/data/metrics/bleu.py``
(``tests/test_torch_metrics.py`` holds the two equal).
"""

from __future__ import annotations

import math
from collections import Counter

__all__ = ["corpus_bleu"]


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def corpus_bleu(
    hypotheses: dict[int, list[list[str]]],
    references: dict[int, list[list[str]]],
    max_n: int = 4,
) -> list[float]:
    """Returns [BLEU-1, ..., BLEU-max_n]. ``hypotheses[img]`` must hold exactly
    one tokenized caption; ``references[img]`` one or more."""
    clipped = [0] * max_n
    totals = [0] * max_n
    hyp_len = 0
    ref_len = 0

    for img_id, hyps in hypotheses.items():
        hyp = hyps[0]
        refs = references[img_id]
        hyp_len += len(hyp)
        # closest reference length (ties → shorter)
        ref_len += min((abs(len(r) - len(hyp)), len(r)) for r in refs)[1]
        for n in range(1, max_n + 1):
            hyp_counts = _ngrams(hyp, n)
            max_ref = Counter()
            for r in refs:
                for ng, c in _ngrams(r, n).items():
                    if c > max_ref[ng]:
                        max_ref[ng] = c
            totals[n - 1] += max(len(hyp) - n + 1, 0)
            clipped[n - 1] += sum(min(c, max_ref[ng]) for ng, c in hyp_counts.items())

    bp = 1.0 if hyp_len > ref_len else math.exp(1.0 - ref_len / max(hyp_len, 1))
    scores = []
    log_sum = 0.0
    for n in range(max_n):
        p_n = clipped[n] / totals[n] if totals[n] > 0 else 0.0
        log_sum += math.log(p_n) if p_n > 0 else -1e10
        scores.append(bp * math.exp(log_sum / (n + 1)))
    return scores
