"""PTB-style caption tokenizer (pure Python).

pycocoevalcap preprocesses captions through the Stanford PTBTokenizer Java jar
before scoring (the reference's MetricEval inherits this —
the reference's ``dataset.py:277-298``). This is a dependency-free approximation
of its observable behavior on caption text: lowercase, strip the punctuation set
PTB removes, split on whitespace.

The port's copy of ``fpn_mt_image_captioning_tpu/data/metrics/ptb.py``
(``tests/test_torch_metrics.py`` holds the two equal).
"""

from __future__ import annotations

import re

__all__ = ["ptb_tokenize", "tokenize_corpus"]

_PUNCT = re.compile(r"[\[\]\"{}()=+\\_\-><@`,;:!?.*’‘“”]")
_WS = re.compile(r"\s+")


def ptb_tokenize(caption: str) -> list[str]:
    s = caption.lower()
    s = _PUNCT.sub(" ", s)
    s = _WS.sub(" ", s).strip()
    return s.split(" ") if s else []


def tokenize_corpus(captions: dict[int, list[str]]) -> dict[int, list[list[str]]]:
    """{image_id: [caption, ...]} → {image_id: [tokens, ...]}"""
    return {k: [ptb_tokenize(c) for c in v] for k, v in captions.items()}
