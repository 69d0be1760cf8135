"""What the drivers share: the captioner's objects built from a
configuration file (its ``Config``, its tokenizer over the synthetic
vocabulary, a pipeline on the seeded weights), the host clock, and the
reference built from the same seed."""

from __future__ import annotations

import dataclasses
import gc
import time

import torch

from . import inputs


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def program_config(cfg: dict, **extra):
    """The captioner's ``Config`` of the configuration file: every key that
    names one of its fields, then ``extra``."""
    from fpn_mt_image_captioning_torch.config import Config

    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in cfg.items() if k in names}, **extra)


def tokenizer(vocab: int):
    """The captioner's tokenizer fitted on the synthetic vocabulary: pad 0,
    ``unk`` 1, ``<start>`` 2, ``<end>`` 3, then the words."""
    from fpn_mt_image_captioning_torch.data.tokenizer import REFERENCE_FILTERS, Tokenizer

    words = inputs.vocabulary(vocab)[len(inputs.VOCAB_PREFIX):]
    tok = Tokenizer(num_words=10000, oov_token="unk", filters=REFERENCE_FILTERS)
    tok.fit_on_texts(["<start> " + " ".join(words[i:i + 10]) + " <end>"
                      for i in range(0, len(words), 10)])
    tok.add_padding_token()
    if (len(tok.index_word), tok.word_index["<start>"], tok.word_index["<end>"]) != (vocab, 2, 3):
        raise RuntimeError("the synthetic vocabulary does not have the ids the harness assumes")
    return tok


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference(cfg: dict, vocab: int, state: dict, device, numerics=None):
    """The float32 reference on ``device`` with the run's weights ``state``
    (the harness's own, kept from set-up), its products rounded by
    ``numerics``. TF32 stays off from here on: the captioner has run."""
    from .reference.model import set_numerics

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = inputs.reference_model(cfg, vocab, device)
    model.load_state_dict(state)
    if numerics is not None:
        set_numerics(model, numerics)
    return model.eval()
