"""Faults planted in the captioner under a run, each of which has to turn
``correct`` false: the CPU rehearsal (``tests/test_gpubench_rehearsal.py``)
plants each at a tiny size, and ``control.py --faults`` reads the ones that
set a limit on the card at the cell's own size. Each takes the captioner's
``Pipeline`` class and a ``setattr(obj, name, value)`` that undoes itself
(pytest's ``monkeypatch.setattr``, or ``Planted`` below)."""

from __future__ import annotations

import torch


class Planted:
    """``setattr`` that remembers the old values; ``undo`` puts them back."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self.saved:
            obj, name, value = self.saved.pop()
            setattr(obj, name, value)


# ------------------------------------------------------------------ captioning
def flip_token(pipeline_cls, setattr):
    """A served token altered where it is produced."""
    predict = pipeline_cls.predict_batch

    def altered(self, images, beam_n=None):
        seqs, lengths = predict(self, images, beam_n)
        seqs = seqs.copy()
        seqs[:, 2] = (seqs[:, 2] + 1) % len(self.tokenizer.index_word)
        return seqs, lengths

    setattr(pipeline_cls, "predict_batch", altered)


def half_batch_caption(pipeline_cls, setattr):
    """Half of the batch captioned, its captions served for the rest."""
    predict = pipeline_cls.predict_batch

    def half(self, images, beam_n=None):
        n = len(images) // 2
        seqs, lengths = predict(self, images[:n], beam_n)
        return seqs.repeat(2, 0), lengths.repeat(2, 0)

    setattr(pipeline_cls, "predict_batch", half)


def stale_cache(_pipeline_cls, setattr):
    """A decode step that returns its state unchanged: the self-attention
    cache is put back as it was after every step."""
    import fpn_mt_image_captioning_torch.decode.beam_search as bs

    step = bs.fused_decode_step

    def stale(packed, cache, *args, **kwargs):
        saved = {k: v.clone() for k, v in cache.items() if k in ("k_self", "v_self")}
        out = step(packed, cache, *args, **kwargs)
        for k, v in saved.items():
            cache[k].copy_(v)
        return out

    setattr(bs, "fused_decode_step", stale)


def topk_skips_best(_pipeline_cls, setattr):
    """The step's top-k returns each row's candidates of ranks 2 to k + 1,
    each with its true score: the served captions stay consistent with
    their scores, but the search never takes a row's best token."""
    import fpn_mt_image_captioning_torch.decode.beam_search as bs

    step = bs.fused_decode_step

    def skipped(*args, topk=None, beam=None, **kwargs):
        k = topk if topk is not None else beam
        top_s, top_i, cache = step(*args, topk=k + 1, beam=beam, **kwargs)
        return top_s[:, 1:].contiguous(), top_i[:, 1:].contiguous(), cache

    setattr(bs, "fused_decode_step", skipped)


# ------------------------------------------------------------------ training
def _restore_after(pipeline_cls, setattr, which, after: int = 0):
    """A training step that puts back the parameters ``which(name)`` selects
    as they were before it, on every step from the ``after``-th on."""
    train_step = pipeline_cls.train_step

    def step(self, img, caps):
        self._fault_steps = getattr(self, "_fault_steps", 0) + 1
        if self._fault_steps <= after:
            return train_step(self, img, caps)
        params = [p for n, p in self.state.model.named_parameters() if which(n)]
        before = [p.detach().clone() for p in params]
        loss = train_step(self, img, caps)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return loss

    setattr(pipeline_cls, "train_step", step)


def unchanged_state(pipeline_cls, setattr):
    """A step that returns the parameters unchanged."""
    _restore_after(pipeline_cls, setattr, lambda n: True)


def frozen_batchnorm(pipeline_cls, setattr):
    """A step that leaves the BatchNorm scales and offsets as they were."""
    _restore_after(pipeline_cls, setattr, lambda n: "bn" in n.split("."))


def unchanged_after_warmup(pipeline_cls, setattr):
    """Sound for the first three steps (set-up's), then unchanged: a fault
    that takes effect after warm-up, as a graph captured late would."""
    _restore_after(pipeline_cls, setattr, lambda n: True, after=3)


def half_batch_train(pipeline_cls, setattr):
    """A step on the first half of the batch, the mean over those rows."""
    train_step = pipeline_cls.train_step

    def half(self, img, caps):
        n = len(img) // 2
        return train_step(self, img[:n], caps[:n])

    setattr(pipeline_cls, "train_step", half)


CAPTION = (flip_token, half_batch_caption, stale_cache, topk_skips_best)
TRAIN = (unchanged_state, frozen_batchnorm, unchanged_after_warmup, half_batch_train)
