"""Word tokenizer with Keras ``text.Tokenizer`` semantics and JSON wire-format.

The reference fits a ``tf.keras.preprocessing.text.Tokenizer`` with
``num_words=TOP_K, oov_token="unk", filters='!"#$%&()*+-/:;=?@[\\]^_`{|}~ '``
(reference ``dataset.py:61-63``), injects the padding token ``'' -> 0``
(``dataset.py:67-68``), and persists it via a *double-encoded* JSON file
(``json.dumps(tokenizer.to_json())`` — ``dataset.py:137-146``). This module
reimplements those exact semantics TF-free so that:

  * tokenizer JSON files produced by the reference load unchanged, and
  * files we write load in the reference.

Behavioral contract (verified against Keras source):
  * lowercasing on, filter chars translated to the split char, split on ' ';
  * vocab indices assigned by descending count (stable on ties → first-seen order),
    with the OOV token forced to index 1;
  * ``texts_to_sequences`` maps unknown / above-``num_words`` words to the OOV index;
  * ``sequences_to_texts`` joins known indices with spaces.
"""

from __future__ import annotations

import json
from collections import OrderedDict, defaultdict
from typing import Iterable, Sequence

__all__ = [
    "Tokenizer",
    "text_to_word_sequence",
    "pad_sequences",
    "load_tokenizer_from_path",
    "store_tokenizer_to_path",
]

DEFAULT_FILTERS = '!"#$%&()*+-/:;=?@[\\]^_`{|}~\t\n'
# The reference's filter set (keeps '.', ',', '<', '>', "'" so <start>/<end> survive):
REFERENCE_FILTERS = '!"#$%&()*+-/:;=?@[\\]^_`{|}~ '


def text_to_word_sequence(
    text: str,
    filters: str = DEFAULT_FILTERS,
    lower: bool = True,
    split: str = " ",
) -> list[str]:
    if lower:
        text = text.lower()
    translate_map = {ord(c): split for c in filters}
    text = text.translate(translate_map)
    return [w for w in text.split(split) if w]


class Tokenizer:
    """Keras-semantics word tokenizer (TF-free)."""

    def __init__(
        self,
        num_words: int | None = None,
        filters: str = DEFAULT_FILTERS,
        lower: bool = True,
        split: str = " ",
        char_level: bool = False,
        oov_token: str | None = None,
        document_count: int = 0,
        analyzer=None,
    ):
        if char_level:
            raise NotImplementedError("char_level tokenization is not used by the reference")
        self.num_words = num_words
        self.filters = filters
        self.lower = lower
        self.split = split
        self.char_level = char_level
        self.oov_token = oov_token
        self.document_count = document_count
        self.word_counts: "OrderedDict[str, int]" = OrderedDict()
        self.word_docs: dict[str, int] = defaultdict(int)
        self.index_docs: dict[int, int] = defaultdict(int)
        self.word_index: dict[str, int] = {}
        self.index_word: dict[int, str] = {}

    # ------------------------------------------------------------------
    def fit_on_texts(self, texts: Iterable[str]) -> None:
        for text in texts:
            self.document_count += 1
            seq = text_to_word_sequence(text, self.filters, self.lower, self.split)
            for w in seq:
                self.word_counts[w] = self.word_counts.get(w, 0) + 1
            for w in set(seq):
                self.word_docs[w] += 1

        wcounts = list(self.word_counts.items())
        wcounts.sort(key=lambda x: x[1], reverse=True)  # stable: ties keep first-seen order
        if self.oov_token is None:
            sorted_voc = []
        else:
            sorted_voc = [self.oov_token]
        sorted_voc.extend(wc[0] for wc in wcounts)

        # indices start at 1 (0 reserved for padding)
        self.word_index = dict(zip(sorted_voc, range(1, len(sorted_voc) + 1)))
        self.index_word = {c: w for w, c in self.word_index.items()}
        self.index_docs = defaultdict(int)
        for w, c in list(self.word_docs.items()):
            self.index_docs[self.word_index[w]] = c

    # ------------------------------------------------------------------
    def add_padding_token(self) -> None:
        """Reference parity: ``tokenizer.word_index[''] = 0; index_word[0] = ''``
        (reference ``dataset.py:67-68``)."""
        self.word_index[""] = 0
        self.index_word[0] = ""

    # ------------------------------------------------------------------
    def texts_to_sequences(self, texts: Iterable[str]) -> list[list[int]]:
        return [self._text_to_sequence(t) for t in texts]

    def _text_to_sequence(self, text: str) -> list[int]:
        num_words = self.num_words
        oov_index = self.word_index.get(self.oov_token) if self.oov_token else None
        vect: list[int] = []
        for w in text_to_word_sequence(text, self.filters, self.lower, self.split):
            i = self.word_index.get(w)
            if i is not None:
                if num_words and i >= num_words:
                    if oov_index is not None:
                        vect.append(oov_index)
                else:
                    vect.append(i)
            elif oov_index is not None:
                vect.append(oov_index)
        return vect

    # ------------------------------------------------------------------
    def sequences_to_texts(self, sequences: Iterable[Sequence[int]]) -> list[str]:
        return [self._sequence_to_text(s) for s in sequences]

    def _sequence_to_text(self, seq: Sequence[int]) -> str:
        num_words = self.num_words
        oov_index = self.word_index.get(self.oov_token) if self.oov_token else None
        words: list[str] = []
        for num in seq:
            num = int(num)
            word = self.index_word.get(num)
            if word is not None:
                if num_words and num >= num_words:
                    if oov_index is not None:
                        words.append(self.index_word[oov_index])
                else:
                    words.append(word)
            elif oov_index is not None:
                words.append(self.index_word[oov_index])
        return " ".join(words)

    # ------------------------------------------------------------------
    # Keras-compatible JSON wire format (reference dataset.py:96-146)
    def get_config(self) -> dict:
        return {
            "num_words": self.num_words,
            "filters": self.filters,
            "lower": self.lower,
            "split": self.split,
            "char_level": self.char_level,
            "oov_token": self.oov_token,
            "document_count": self.document_count,
            "word_counts": json.dumps(dict(self.word_counts)),
            "word_docs": json.dumps(dict(self.word_docs)),
            "index_docs": json.dumps({str(k): v for k, v in self.index_docs.items()}),
            "index_word": json.dumps({str(k): v for k, v in self.index_word.items()}),
            "word_index": json.dumps(self.word_index),
        }

    def to_json(self, **json_kwargs) -> str:
        return json.dumps(
            {"class_name": "Tokenizer", "config": self.get_config()}, **json_kwargs
        )

    @classmethod
    def from_json(cls, json_string: str) -> "Tokenizer":
        cfg = json.loads(json_string)["config"]
        word_counts = json.loads(cfg.pop("word_counts"))
        word_docs = json.loads(cfg.pop("word_docs"))
        index_docs = {int(k): v for k, v in json.loads(cfg.pop("index_docs")).items()}
        index_word = {int(k): v for k, v in json.loads(cfg.pop("index_word")).items()}
        word_index = json.loads(cfg.pop("word_index"))
        cfg.pop("analyzer", None)
        tok = cls(**cfg)
        tok.word_counts = OrderedDict(word_counts)
        tok.word_docs = defaultdict(int, word_docs)
        tok.index_docs = defaultdict(int, index_docs)
        tok.word_index = word_index
        tok.index_word = index_word
        return tok


# ----------------------------------------------------------------------
def pad_sequences(
    sequences: Sequence[Sequence[int]],
    maxlen: int | None = None,
    padding: str = "post",
    truncating: str = "post",
    value: int = 0,
):
    """Post-pad token id lists into a dense int32 array (reference dataset.py:83)."""
    import numpy as np

    if maxlen is None:
        maxlen = max((len(s) for s in sequences), default=0)
    out = np.full((len(sequences), maxlen), value, dtype=np.int32)
    for i, s in enumerate(sequences):
        if not len(s):
            continue
        if len(s) > maxlen:
            s = s[:maxlen] if truncating == "post" else s[-maxlen:]
        if padding == "post":
            out[i, : len(s)] = s
        else:
            out[i, -len(s):] = s
    return out


# ----------------------------------------------------------------------
# File persistence — double-encoded JSON, byte-compatible with the reference
# (store: json.dumps(to_json()) → file contains a JSON string; load: json.load →
# str → from_json). Reference dataset.py:125-146.
def load_tokenizer_from_path(path) -> Tokenizer:
    with open(path) as f:
        data = json.load(f)
    return Tokenizer.from_json(data)


def store_tokenizer_to_path(tokenizer: Tokenizer, path) -> None:
    tokenizer_json = tokenizer.to_json()
    with open(path, "w", encoding="utf-8") as f:
        f.write(json.dumps(tokenizer_json, ensure_ascii=False))
