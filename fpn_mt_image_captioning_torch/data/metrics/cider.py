"""CIDEr-D scorer (pure Python).

Implements the CIDEr-D algorithm as computed by pycocoevalcap's Cider scorer —
the metric that gates checkpointing and early stopping in the reference
(the reference's ``train.py:76-90``, ``dataset.py:277-298``):

  * tf-idf vectors over 1..4-grams per caption; idf = log(N_images) - log(df),
    with document frequency counted over each image's reference set;
  * candidate term frequencies *min-clipped* against the reference's when
    computing the inner product (the "-D" modification);
  * a Gaussian length penalty exp(-(len_h - len_r)^2 / (2·sigma^2)), sigma = 6;
  * per-image score = mean over n of the clipped cosine similarity, averaged
    over references, × 10; corpus score = mean over images.

The port's copy of ``fpn_mt_image_captioning_tpu/data/metrics/cider.py``
(``tests/test_torch_metrics.py`` holds the two equal).
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict

__all__ = ["CiderScorer", "cider_d"]

_N = 4
_SIGMA = 6.0


def _ngram_counts(tokens: list[str]) -> Counter:
    counts: Counter = Counter()
    for n in range(1, _N + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i : i + n])] += 1
    return counts


class CiderScorer:
    def __init__(self, sigma: float = _SIGMA):
        self.sigma = sigma

    def compute(
        self,
        hypotheses: dict[int, list[list[str]]],
        references: dict[int, list[list[str]]],
    ) -> tuple[float, dict[int, float]]:
        img_ids = list(hypotheses.keys())
        # document frequency over reference sets
        df: dict[tuple, float] = defaultdict(float)
        ref_counts = {}
        for img_id in img_ids:
            counts = [_ngram_counts(r) for r in references[img_id]]
            ref_counts[img_id] = counts
            seen = set()
            for c in counts:
                seen.update(c.keys())
            for ng in seen:
                df[ng] += 1.0

        log_n = math.log(max(len(img_ids), 1))
        per_image: dict[int, float] = {}

        def to_vec(counts: Counter):
            vec = [defaultdict(float) for _ in range(_N)]
            norm = [0.0] * _N
            length = 0
            for ng, tf in counts.items():
                idf = log_n - math.log(max(1.0, df[ng]))
                n_idx = len(ng) - 1
                vec[n_idx][ng] = tf * idf
                norm[n_idx] += vec[n_idx][ng] ** 2
                if n_idx == 0:
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        for img_id in img_ids:
            hyp_vec, hyp_norm, hyp_len = to_vec(_ngram_counts(hypotheses[img_id][0]))
            score = 0.0
            for rc, ref in zip(ref_counts[img_id], references[img_id]):
                ref_vec, ref_norm, ref_len = to_vec(rc)
                delta = float(hyp_len - ref_len)
                val = [0.0] * _N
                for n_idx in range(_N):
                    for ng, w in hyp_vec[n_idx].items():
                        val[n_idx] += min(w, ref_vec[n_idx][ng]) * ref_vec[n_idx][ng]
                    denom = hyp_norm[n_idx] * ref_norm[n_idx]
                    if denom != 0:
                        val[n_idx] /= denom
                    val[n_idx] *= math.exp(-(delta**2) / (2 * self.sigma**2))
                score += sum(val) / _N
            n_refs = max(len(references[img_id]), 1)
            per_image[img_id] = score / n_refs * 10.0

        corpus = sum(per_image.values()) / max(len(per_image), 1)
        return corpus, per_image


def cider_d(hypotheses, references) -> float:
    return CiderScorer().compute(hypotheses, references)[0]
