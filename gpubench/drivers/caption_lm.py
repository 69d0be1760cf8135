"""Closed-loop captioning by a captioner whose decoder is a language model
(``configs/kimi_vl_a3b_resnet50.json``: Kimi-VL-A3B's, over the FPN-MT
encoder). The traffic and what the check keeps are ``caption_closed``'s:
one caller sends ``Pipeline.predict_batch`` calls of ``batch`` seeded uint8
images back to back over ``pool`` distinct batches, and the check reads
``check_images`` images of ``check_calls`` kept calls against the plain
reference (``reference/kimi_vl.py``).

The weights (``inputs_lm``): the encoder's drawn as the caption cells draw
theirs, kept on the host (140 MB); the language model's drawn on the device
leaf by leaf in the compute dtype and handed to the pipeline, with no copy
kept: the reference draws them again from the seed after the pipeline is
released. The pipeline's ``Config`` carries the configuration's published
``text_config`` keys as ``language_model``.

A traced run also profiles the prefill (``CaptionLM.init_beam_cache``) on
its own, so that the decode steps' card time is the calls' less the encodes'
and the prefills'; the profiler names no idle gaps (a call is some thousands
of kernels)."""

from __future__ import annotations

import statistics

import torch

from .. import counts, counts_lm, harness, inputs_lm, judge, profiling
from . import caption_closed

START, END = caption_closed.START, caption_closed.END
# a language model larger than this is not built on a CPU (a rehearsal there
# runs a tiny text config): 16 B float32 parameters would take 64 GB of host memory
CPU_PARAMETERS = 10**9


class Run(caption_closed.Run):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.vocab, self.max_len = cfg["vocab_size"], cfg["max_seq_len"]
        self.dtype = getattr(torch, cfg["compute_dtype"])
        self._reference = None

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from fpn_mt_image_captioning_torch.models.kimi_vl import (TEXT_CONFIG_KEYS,
                                                                  language_model_parameters)
        from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

        cfg, t, dev = self.cfg, self.traffic, self.device
        text = {k: cfg[k] for k in TEXT_CONFIG_KEYS}
        if dev.type != "cuda" and language_model_parameters(text) > CPU_PARAMETERS:
            raise RuntimeError(f"{cfg['name']}'s language model is built on a CUDA card only; "
                               "a CPU rehearsal gives it a tiny text config")
        self.encoder_state = {k: v.cpu() for k, v in
                              inputs_lm.encoder_weights(cfg, self.seed, dev).items()}
        state = inputs_lm.weights(cfg, self.seed, dev, self.encoder_state, self.dtype)
        self.pipe = Pipeline(harness.tokenizer(self.vocab), self.max_len,
                             harness.program_config(cfg, language_model=text), state, device=dev)
        del state
        self._wrap()
        self.make_pool()
        for _ in range(t["warmup_calls"]):
            self.pipe.predict_batch(self.pool[0])
        harness.sync(dev)

    # ---------------------------------------------------------------- trace
    def trace(self) -> dict:
        """``caption_closed``'s spans and profiled calls, and the card's time
        of ``trace_calls`` prefills of the pool's first batch."""
        t, pipe, dev = self.traffic, self.pipe, self.device
        images = self.pool[0]
        harness.sync(dev)
        t0 = harness.now()
        for _ in range(t["span_calls"]):
            pipe.encode(images)
        harness.sync(dev)
        encode_s = (harness.now() - t0) / t["span_calls"]
        call_s, self._search_s = [], []
        for _ in range(t["span_calls"]):
            t0 = harness.now()
            pipe.predict_batch(images)
            call_s.append(harness.now() - t0)
        search_s, self._search_s = statistics.fmean(self._search_s), None
        calls, beam = t["trace_calls"], self.cfg["beam_search_n"]
        enc = pipe.encode(images)
        self._encodes.clear()
        self._scores.clear()
        model = pipe.transformer
        predict = profiling.profile_calls(lambda: [pipe.predict_batch(images) for _ in range(calls)],
                                          name_gaps=False)
        encode = profiling.profile_calls(lambda: [pipe.encode(images) for _ in range(calls)],
                                         name_gaps=False)
        prefill = profiling.profile_calls(
            lambda: [model.init_beam_cache(enc, beam, self.max_len + 1) for _ in range(calls)],
            name_gaps=False)
        self._encodes.clear()
        self._scores.clear()
        ref = inputs_lm.reference_model(self.cfg)
        lenc = enc.shape[1]
        self.measured = {
            "calls": len(self.latencies), "images": sum(len(o[1]) for o in self.outputs),
            "latencies": self.latencies,
            "window_s": self.window_s, "call_s": statistics.fmean(self.latencies),
            "encode_s": encode_s, "search_s": search_s, "span_call_s": statistics.fmean(call_s),
            "steps": self.max_len, "trace_calls": calls,
            "predict_busy_s": predict["busy_s"], "encode_busy_s": encode["busy_s"],
            "prefill_busy_s": prefill["busy_s"],
            "call_flops": counts.encode_flops(ref, t["batch"], images.shape[1])
            + counts_lm.call_flops(self.cfg, t["batch"], lenc, self.max_len),
            "items": t["batch"], "lenc": lenc, "cfg": self.cfg, "vocab": self.vocab,
        }
        return {"busy_s": predict["busy_s"], "window_s": predict["wall_s"],
                "breakdown": {"device_ops": predict["device_ops"],
                              "idle_gaps": predict["idle_gaps"]}}

    # ---------------------------------------------------------------- check
    def reference(self):
        """The float32 reference on the run's weights, drawn again from the
        seed (the pipeline released first); made once."""
        if self._reference is None:
            state = inputs_lm.weights(self.cfg, self.seed, self.device, self.encoder_state,
                                      self.dtype)
            self._reference = inputs_lm.reference(self.cfg, state, self.device)
        return self._reference

    def check(self) -> dict:
        b = self.traffic["batch"]
        if any(len(o[3]) != b for o in self.outputs) or any(
                len(e) != b for _, e in self.kept.values()):
            return dict.fromkeys(("enc_gap", "score_err", "beam_gap"), float("inf"))
        images, enc, seqs, lengths, scores = self.sample()
        numbers, distinct = judge.caption_numbers(
            self.reference(), images, enc, seqs, lengths, scores, beam=self.cfg["beam_search_n"],
            max_len=self.max_len, start=START, end=END)
        if hasattr(self, "measured"):
            self.measured["distinct"] = distinct
        return numbers
