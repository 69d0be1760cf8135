"""Closed-loop captioning: one caller sends ``Pipeline.predict_batch`` calls
of ``batch`` seeded uint8 images back to back, cycling over a pool of
``pool`` distinct batches. A request is one call; its latency runs from
when it was due (the previous call's return) to when its captions are host
arrays.

What the check reads is kept from the timed calls themselves: the pipeline's
``encode`` and the beam search that ``predict_batch`` calls are wrapped so
that each call's encoder output and best-beam scores are kept (a reference
to the tensors, no copy and no synchronisation). The encoder outputs of
``check_calls`` calls, drawn from the seed as the window runs (a reservoir
sample), are kept to the end; the check reads ``check_images`` images of
those calls.

Traffic keys: ``batch``, ``pool``, ``warmup_calls``, ``span_calls`` (the
encodes, then the calls, timed without the profiler in a traced run),
``trace_calls`` (the calls of a traced run's profiled window;
``caption_device_ms`` profiles one call on each pool batch instead),
``check_images`` (the served images the reference reads), ``check_calls``.

The weights are the configuration's seeded ones at the served scales of
its ``served_weight_scales`` and ``served_end_bias`` (``inputs.make_weights``)."""

from __future__ import annotations

import statistics

import numpy as np
import torch

from .. import counts, harness, inputs, judge, profiling

START, END = 2, 3


class Run:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.vocab, self.max_len = cfg["vocab_size"], cfg["max_seq_len"]
        self.weights = dict(scales=cfg["served_weight_scales"], end_id=END,
                            end_bias=cfg["served_end_bias"])

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

        t, dev = self.traffic, self.device
        variables = inputs.flax_tree(self.make_state(), self.cfg, self.vocab)
        self.pipe = Pipeline(harness.tokenizer(self.vocab), self.max_len,
                             harness.program_config(self.cfg), variables, device=dev)
        del variables
        self._wrap()
        self.make_pool()
        for _ in range(t["warmup_calls"]):
            self.pipe.predict_batch(self.pool[0])
        harness.sync(dev)

    def _wrap(self) -> None:
        """Keep each call's encoder outputs and beam scores (see above)."""
        import fpn_mt_image_captioning_torch.train.pipeline as pipeline

        self._encodes, self._scores, self._search_s = [], [], None
        encode, search, dev = self.pipe.encode, pipeline.beam_search, self.device

        def kept_encode(images):
            out = encode(images)
            self._encodes.append(out)
            return out

        def kept_search(*args, **kwargs):
            if self._search_s is None:
                out = search(*args, **kwargs)
            else:   # timed apart (``trace``): the search syncs at its first step anyway
                harness.sync(dev)
                t0 = harness.now()
                out = search(*args, **kwargs)
                harness.sync(dev)
                self._search_s.append(harness.now() - t0)
            self._scores.append(out[2])
            return out

        self.pipe.encode, pipeline.beam_search = kept_encode, kept_search
        self._unwrap = lambda: setattr(pipeline, "beam_search", search)

    def make_state(self) -> dict:
        """The run's weights on the device; a host copy is kept for the
        reference."""
        state = inputs.make_weights(self.cfg, self.vocab, self.seed, self.device, **self.weights)
        self.state = {k: v.cpu() for k, v in state.items()}
        return state

    def make_pool(self) -> None:
        size, t = self.cfg["image_input_size"], self.traffic
        self.pool = [inputs.images(t["batch"], size, inputs.subseed(self.seed, k), self.device)
                     for k in range(t["pool"])]

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> dict:
        pool, pipe = self.pool, self.pipe
        latencies, self.outputs, self.kept = [], [], {}
        rng = np.random.default_rng(inputs.subseed(self.seed, 1000))
        keep = self.traffic["check_calls"]
        start = harness.now()
        deadline, end = start + seconds, start
        while True:
            due = harness.now()
            if due >= deadline:
                break
            i = len(latencies)
            self._encodes.clear()
            self._scores.clear()
            seqs, lengths = pipe.predict_batch(pool[i % len(pool)])
            end = harness.now()
            latencies.append(end - due)
            self.outputs.append((i % len(pool), seqs, lengths, torch.cat(self._scores)))
            slot = i if i < keep else int(rng.integers(0, i + 1))
            if slot < keep:     # reservoir: each call is kept with chance keep / (i + 1)
                self.kept[slot] = (i, torch.cat(self._encodes))
        self.window_s = end - start
        images = sum(len(o[1]) for o in self.outputs)
        self.latencies = latencies
        return {"attempted": len(latencies), "failed": sum(not self._well_formed(o[1], o[2])
                                                           for o in self.outputs),
                "metrics": {"caption_images_per_s": images / self.window_s}}

    def device_metrics(self, names) -> dict:
        """``caption_device_ms``, where the cell reports it: the card's busy
        time a call, over one call on each of the pool's batches (the
        window's distinct work) under the profiler, once the window has
        closed."""
        if "caption_device_ms" not in names:
            return {}
        pipe, pool = self.pipe, self.pool
        busy = profiling.profile_calls(lambda: [pipe.predict_batch(p) for p in pool],
                                       name_gaps=False)["busy_s"]
        self._encodes.clear()
        self._scores.clear()
        return {"caption_device_ms": 1e3 * busy / len(pool)}

    def _well_formed(self, seqs, lengths) -> bool:
        b = self.traffic["batch"]
        return (seqs.shape == (b, self.max_len) and seqs.dtype == np.int32
                and lengths.shape == (b,) and bool(((seqs >= 0) & (seqs < self.vocab)).all())
                and bool(((lengths >= 0) & (lengths <= self.max_len)).all()))

    # ---------------------------------------------------------------- trace
    def trace(self) -> dict:
        """The spans and the profiled windows that the per-layer metrics
        read: the wall of ``span_calls`` encodes; the wall of ``span_calls``
        calls of ``predict_batch`` and of the beam search inside each, the
        card synchronised around both (no profiler runs: it slows the host);
        and the device's busy time over ``trace_calls`` calls of
        ``predict_batch`` and of ``encode`` under the profiler."""
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
        self._encodes.clear()
        self._scores.clear()
        calls = t["trace_calls"]
        predict = profiling.profile_calls(lambda: [pipe.predict_batch(images) for _ in range(calls)])
        encode = profiling.profile_calls(lambda: [pipe.encode(images) for _ in range(calls)])
        model = inputs.reference_model(self.cfg, self.vocab)
        img = torch.zeros((t["batch"], *images.shape[1:]), dtype=torch.uint8, device="meta")
        lenc = model.encode(img).shape[1]
        self.measured = {
            "calls": len(self.latencies), "images": sum(len(o[1]) for o in self.outputs),
            "latencies": self.latencies,
            "window_s": self.window_s, "call_s": statistics.fmean(self.latencies),
            "encode_s": encode_s, "search_s": search_s, "span_call_s": statistics.fmean(call_s),
            "steps": self.max_len, "trace_calls": calls,
            "predict_busy_s": predict["busy_s"],
            "encode_busy_s": encode["busy_s"],
            "call_flops": counts.encode_flops(model, t["batch"], images.shape[1])
            + counts.decode_flops(self.cfg, self.vocab, t["batch"], lenc, self.max_len),
            "items": t["batch"], "lenc": lenc, "cfg": self.cfg, "vocab": self.vocab,
        }
        return {"busy_s": predict["busy_s"], "window_s": predict["wall_s"],
                "breakdown": {"device_ops": predict["device_ops"],
                              "idle_gaps": predict["idle_gaps"]}}

    # ---------------------------------------------------------------- check
    def release(self) -> None:
        self._unwrap()
        del self.pipe, self._encodes
        harness.free(self.device)

    def sample(self):
        """``check_images`` images of the kept calls drawn from the seed, the
        longest caption among them first: (images, encoder outputs,
        captions, lengths, scores) on the device."""
        rng = np.random.default_rng(inputs.subseed(self.seed, 1001))
        calls = sorted(self.kept.values(), key=lambda c: c[0])
        b = self.traffic["batch"]
        flat = rng.choice(len(calls) * b, min(self.traffic["check_images"], len(calls) * b),
                          replace=False)
        picks = [divmod(int(f), b) for f in flat]
        longest = max(((c, j) for c in range(len(calls)) for j in range(b)),
                      key=lambda cj: self.outputs[calls[cj[0]][0]][2][cj[1]])
        if longest not in picks:
            picks[0] = longest
        rows = [(self.outputs[calls[c][0]], calls[c][1], j) for c, j in picks]
        dev = self.device
        stack = lambda xs: torch.as_tensor(np.stack(xs), device=dev)
        return (stack([self.pool[o[0]][j] for o, _, j in rows]),
                torch.stack([e[j] for _, e, j in rows]).to(dev),
                stack([o[1][j] for o, _, j in rows]), stack([o[2][j] for o, _, j in rows]),
                torch.stack([o[3][j] for o, _, j in rows]).to(dev))

    def check(self) -> dict:
        b = self.traffic["batch"]
        if any(len(o[3]) != b for o in self.outputs) or any(
                len(e) != b for _, e in self.kept.values()):
            # a call whose encoder output or scores do not cover its batch
            return dict.fromkeys(("enc_gap", "score_err", "beam_gap"), float("inf"))
        images, enc, seqs, lengths, scores = self.sample()
        model = harness.reference(self.cfg, self.vocab, self.state, self.device)
        numbers, distinct = judge.caption_numbers(
            model, images, enc, seqs, lengths, scores, beam=self.cfg["beam_search_n"],
            max_len=self.max_len, start=START, end=END)
        if hasattr(self, "measured"):
            self.measured["distinct"] = distinct
        return numbers
