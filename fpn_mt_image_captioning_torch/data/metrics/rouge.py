"""ROUGE-L for captioning (pycocoevalcap formulation).

Per image: LCS-based precision/recall against each reference, take the max of
each across references, combine with F-beta (beta = 1.2), then average over
images — matching pycocoevalcap's rouge.py behavior used by the reference's
MetricEval.

The port's copy of ``fpn_mt_image_captioning_tpu/data/metrics/rouge.py``
(``tests/test_torch_metrics.py`` holds the two equal).
"""

from __future__ import annotations

__all__ = ["rouge_l"]

_BETA = 1.2


def _lcs_len(a: list[str], b: list[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        curr = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            curr[j] = prev[j - 1] + 1 if x == y else max(prev[j], curr[j - 1])
        prev = curr
    return prev[-1]


def rouge_l(
    hypotheses: dict[int, list[list[str]]],
    references: dict[int, list[list[str]]],
) -> float:
    total = 0.0
    for img_id, hyps in hypotheses.items():
        hyp = hyps[0]
        precs, recs = [], []
        for ref in references[img_id]:
            lcs = _lcs_len(hyp, ref)
            precs.append(lcs / len(hyp) if hyp else 0.0)
            recs.append(lcs / len(ref) if ref else 0.0)
        p, r = max(precs, default=0.0), max(recs, default=0.0)
        if p != 0 and r != 0:
            total += ((1 + _BETA**2) * p * r) / (r + _BETA**2 * p)
    return total / max(len(hypotheses), 1)
