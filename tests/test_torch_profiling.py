"""The port's profiling module (``fpn_mt_image_captioning_torch/utils/
profiling.py``) on the CPU: ``StepTracer`` with the semantics of the JAX
package's (``tests/test_aux_components.py``: a trace over the step window,
an idempotent ``close``, a run with fewer steps than the window), ``trace``
and ``sync``; the span registry (counts, nesting, self time, the bounded
ring, the summary, a reset of all or of a prefix, one stack a thread); the
spans of
``predict_batch`` and ``train_step``, counted without a profiler (and no
``record_function`` entered) and nested in a profiled trace; no span while
``export_serving`` traces; and the benchmark's eight readers of the spans
(``gpubench/metrics/``), loaded by path, on a small float32 model."""

import glob
import importlib.util
import json
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_torch import export as ex
from fpn_mt_image_captioning_torch.config import Config
from fpn_mt_image_captioning_torch.data.tokenizer import REFERENCE_FILTERS, Tokenizer
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from fpn_mt_image_captioning_torch.utils import profiling
from fpn_mt_image_captioning_torch.utils.profiling import (REGISTRY, SpanRegistry, StepTracer,
                                                           annotate, sync, trace)

CFG = Config(image_input_size=256, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
             num_heads=4, dff=64, compute_dtype="float32", beam_search_n=2)
MAX_LEN, BATCH = 4, 2
METRICS = Path(__file__).resolve().parents[1] / "gpubench" / "metrics"
TRAIN_PHASES = ("train.step", "train.issue", "train.upload", "train.forward", "train.backward",
                "train.clip", "train.clip.wait", "train.optimizer", "train.readback")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (see
    tests/test_torch_backbones.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_registry():
    REGISTRY.reset()
    yield
    REGISTRY.reset()


def traces(logdir) -> list[str]:
    return glob.glob(f"{logdir}/*.pt.trace.json")


def test_step_tracer_captures_window(tmp_path):
    """The trace opens at ``start``, closes at ``stop`` and is written then:
    it holds the ops of steps 1 and 2 and none of steps 0, 3 and 4;
    ``close()`` is idempotent; with fewer steps than the window, ``close()``
    ends the open trace and writes it."""
    logdir = tmp_path / "profile"
    tracer = StepTracer(str(logdir), start=1, stop=3)
    x = torch.ones((8, 8))
    for i in range(5):
        tracer.step(i)
        with annotate(f"step{i}"):
            x @ x
        if i == 2:
            assert not traces(logdir)   # still open
    tracer.close()
    tracer.close()
    [path] = traces(logdir)
    names = {e.get("name") for e in json.loads(open(path).read())["traceEvents"]}
    assert {"step1", "step2"} <= names and not names & {"step0", "step3", "step4"}
    # the profiled steps' spans are in the trace, not in the registry
    assert REGISTRY.names() == ["step0", "step3", "step4"]

    tracer2 = StepTracer(str(tmp_path / "p2"), start=0, stop=10)
    tracer2.step(0)
    x @ x
    tracer2.close()
    assert len(traces(tmp_path / "p2")) == 1


def test_trace_and_annotate(tmp_path):
    with trace(str(tmp_path / "t")) as logdir:
        with annotate("span"):
            torch.ones(4).sum()
    [path] = traces(logdir)
    events = json.loads(open(path).read())["traceEvents"]
    assert any(e.get("name") == "span" and e.get("cat") == "user_annotation" for e in events)
    assert REGISTRY.names() == []
    with annotate("outside a trace"):
        pass
    assert REGISTRY.names() == ["outside a trace"]


def test_sync_on_the_cpu_is_a_noop(monkeypatch):
    called = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: called.append(a))
    sync({"a": torch.ones(2), "b": [torch.zeros(1), (3, None)]})
    sync(None)
    assert called == []


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------
@pytest.fixture
def ticks(monkeypatch):
    """The span clock ticks 10 ns a read, from a base after the last reset;
    returns the base."""
    base = profiling._clock()
    clock = iter(range(base + 10, base + 10**9, 10))
    monkeypatch.setattr(profiling, "_clock", lambda: next(clock))
    return base


class Nesting(SpanRegistry):
    """A registry that also notes, for each span it counts, the enclosing
    span: the innermost one still open on the thread that ends it."""

    def __init__(self):
        super().__init__()
        self.parents = []

    def add(self, name, *args):
        stack = getattr(profiling._open, "stack", [])
        self.parents.append((name, stack[-1].name if stack else None))
        super().add(name, *args)


@pytest.fixture
def nesting(monkeypatch):
    registry = Nesting()
    monkeypatch.setattr(profiling, "REGISTRY", registry)
    return registry


def test_spans_nest_share_call_ids_and_keep_self_time(ticks, nesting):
    with annotate("outer", cpu=True):                     # clock 10
        with annotate("a"):                               # 20
            pass                                          # 30
        with annotate("b"):                               # 40
            with annotate("a", wait=True):                # 50
                pass                                      # 60
        # 70
    with annotate("loose"):                               # 80, 90
        pass
    with annotate("outer", cpu=True):                     # 100, 110
        pass
    assert nesting.parents == [("a", "outer"), ("a", "b"), ("b", "outer"), ("outer", None),
                               ("loose", None), ("outer", None)]
    assert list(nesting._stats["outer"].ring) == [70, 10]
    assert list(nesting._stats["b"].ring) == [30]
    assert set(nesting.summary("loose")) == {"steps", "mean_ms", "p50_ms", "p90_ms", "p99_ms",
                                             "self_ms"}
    s = nesting.summary("a")
    assert (s["steps"], s["mean_ms"], s["p50_ms"], s["self_ms"]) == (2, 1e-5, 1e-5, 1e-5)
    # the wait, and each span around it: its own wait, and its median less it
    assert (s["wait_ms"], s["host_p50_ms"]) == pytest.approx((5e-6, 5e-6))
    s = nesting.summary("b")
    assert (s["self_ms"], s["wait_ms"], s["host_p50_ms"]) == pytest.approx((2e-5, 1e-5, 2e-5))
    s = nesting.summary("outer")
    assert s["steps"] == 2 and s["mean_ms"] == 4e-5 and s["cpu_ms"] >= 0
    assert s["self_ms"] == pytest.approx((30 + 10) / 2 / 1e6)
    assert (s["wait_ms"], s["host_p50_ms"]) == pytest.approx((5e-6, (60 + 10) / 2 / 1e6))
    assert nesting.summary("never") == {}
    assert nesting.names() == ["a", "b", "loose", "outer"]


def test_ring_is_bounded_and_reset_and_failures_drop_spans(monkeypatch, ticks):
    small = SpanRegistry(ring=4)
    monkeypatch.setattr(profiling, "REGISTRY", small)
    for _ in range(6):
        with annotate("x"):
            pass
    s = small.summary("x")
    assert s["steps"] == 6 and len(small._stats["x"].ring) == 4
    with annotate("in flight"):
        small.reset()                 # a span open across a reset is left out
        with annotate("after"):
            pass
    assert small.names() == ["after"] and small.summary("x") == {}
    small.record("wait", ticks, ticks + 5)     # begun before the reset: left out
    now = profiling._clock()
    small.record("wait", now, now + 40)
    assert small.summary("wait")["mean_ms"] == 4e-5
    # a reset of a prefix: its names, and those of them still open, start
    # afresh (a name not seen before too); the others keep their spans
    with annotate("serve.open"), annotate("serve.batch"):
        small.reset("serve.")
    with annotate("serve.batch"):
        pass
    assert small.names() == ["after", "serve.batch", "wait"]
    assert small.summary("serve.batch")["steps"] == small.summary("after")["steps"] == 1
    with pytest.raises(ValueError), annotate("outer"):
        with annotate("failed"):
            raise ValueError
    assert profiling._open.stack == [] and not {"outer", "failed"} & set(small.names())


def test_each_thread_has_its_own_stack(nesting):
    barrier = threading.Barrier(2, timeout=30)

    def work(name):
        with annotate(name, cpu=True):
            barrier.wait()            # both spans open at once
            with annotate(name + ".inner"):
                pass

    threads = [threading.Thread(target=work, args=(n,)) for n in ("t1", "t2")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(nesting.parents, key=str) == sorted(
        [("t1", None), ("t2", None), ("t1.inner", "t1"), ("t2.inner", "t2")], key=str)


def test_threads_lose_no_span():
    """Spans ended on many threads at once, while another thread reads the
    registry, are all counted (each under the registry's lock)."""
    import os
    import sys

    threads, per = min(2 * len(os.sched_getaffinity(0)) + 2, 64), 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with annotate("busy"):
                    pass

        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        while any(t.is_alive() for t in pool):
            REGISTRY.summary("busy")
        for t in pool:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert REGISTRY.summary("busy")["steps"] == threads * per


# ---------------------------------------------------------------------------
# the spans of the port's paths
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def pipes(tmp_path_factory):
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(20)]
    tok = Tokenizer(num_words=CFG.top_k, oov_token="unk", filters=REFERENCE_FILTERS)
    tok.fit_on_texts(["<start> " + " ".join(rng.choice(words, 4)) + " <end>"
                      for _ in range(20)])
    tok.add_padding_token()
    serve = Pipeline(tok, MAX_LEN, CFG, seed=0, device="cpu")
    train = Pipeline(tok, MAX_LEN, CFG, seed=0, device="cpu",
                     checkpoint_path=str(tmp_path_factory.mktemp("ckpt")))
    images = rng.integers(0, 256, (BATCH, 256, 256, 3), dtype=np.uint8)
    caps = np.zeros((BATCH, MAX_LEN), np.int64)
    caps[:, :3] = [2, 5, 3]
    return serve, train, images, caps


def no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_predict_batch_counts_its_spans(pipes, monkeypatch, nesting):
    """Without a profiler: one call's spans, T beam steps each with its
    stop test and its issue, one decode step an issue, all in the call."""
    serve, _, images, _ = pipes
    no_record_function(monkeypatch)
    seqs, lengths = serve.predict_batch(images)
    counts = {n: nesting.summary(n)["steps"] for n in nesting.names()}
    t = counts["beam.issue"]
    assert t == max(lengths) or t == MAX_LEN
    stopped = int(t < MAX_LEN)          # the stop test that ended the loop is a step too
    assert counts == {"predict.call": 1, "predict.upload": 1, "predict.encode": 1,
                      "model.pe_upload": 5, "predict.to_host": 1, "beam.step": t + stopped,
                      "beam.sync": t + stopped, "beam.issue": t, "beam.kernels": t}
    assert set(nesting.parents) == {
        ("predict.call", None), ("predict.upload", "predict.call"),
        ("predict.encode", "predict.call"), ("model.pe_upload", "predict.encode"),
        ("beam.step", "predict.call"),
        ("beam.sync", "beam.step"), ("beam.issue", "beam.step"), ("beam.kernels", "beam.issue"),
        ("predict.to_host", "predict.call")}
    s = nesting.summary("predict.call")
    assert s["cpu_ms"] > 0 and 0 < s["wait_ms"] < s["mean_ms"]


def test_train_step_counts_its_spans(pipes, monkeypatch, nesting):
    _, train, images, caps = pipes
    no_record_function(monkeypatch)
    train.train_step(images, caps)
    assert nesting.names() == sorted(TRAIN_PHASES + ("model.pe_upload",))
    assert all(nesting.summary(n)["steps"] == 1 for n in TRAIN_PHASES)
    assert nesting.summary("model.pe_upload")["steps"] == 5 + 1   # the encoder's, the decoder's
    assert dict(nesting.parents) == {
        "train.step": None, "train.issue": "train.step", "train.readback": "train.step",
        "train.clip.wait": "train.clip", "model.pe_upload": "train.forward", **{
            f"train.{p}": "train.issue"
            for p in ("upload", "forward", "backward", "clip", "optimizer")}}
    assert nesting.summary("train.step")["cpu_ms"] > 0


def test_profiled_predict_batch_nests_its_spans(pipes, tmp_path):
    """Under the profiler the spans are ``user_annotation`` events of the
    trace: one ``predict.call`` holds the upload, the encode, the T beam
    steps (each holding its stop test and its issue, the issue its decode
    step) and the copy to the host; the registry takes none of them."""
    serve, _, images, _ = pipes
    with trace(str(tmp_path / "t")) as logdir:
        _, lengths = serve.predict_batch(images)
    assert REGISTRY.names() == []
    [path] = traces(logdir)
    spans = [e for e in json.loads(open(path).read())["traceEvents"]
             if e.get("cat") == "user_annotation"]
    by = {}
    for e in spans:
        by.setdefault(e["name"], []).append(e)

    def inside(e, outer):
        return outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]

    [call] = by.pop("predict.call")
    t = len(by["beam.issue"])
    assert t == max(lengths) or t == MAX_LEN
    stopped = int(t < MAX_LEN)
    assert {n: len(v) for n, v in by.items()} == {
        "predict.upload": 1, "predict.encode": 1, "model.pe_upload": 5, "predict.to_host": 1,
        "beam.step": t + stopped, "beam.sync": t + stopped, "beam.issue": t, "beam.kernels": t}
    assert all(inside(e, call) for v in by.values() for e in v)
    for name, outer in (("beam.sync", "beam.step"), ("beam.issue", "beam.step"),
                        ("beam.kernels", "beam.issue")):
        assert all(any(inside(e, o) for o in by[outer]) for e in by[name]), name


def test_no_span_while_export_traces(pipes, tmp_path, monkeypatch):
    """The program is traced (its file is not written: the trace is what
    this test is about)."""
    serve, _, _, _ = pipes
    traced = []

    def save(ep, path):
        traced.append(ep)
        Path(path).touch()

    monkeypatch.setattr(torch.export, "save", save)
    ex.export_serving(serve, str(tmp_path / "artifact"), batch=1)
    assert traced and REGISTRY.names() == []


# ---------------------------------------------------------------------------
# the benchmark's readers of the spans
# ---------------------------------------------------------------------------
READERS = {"decode_step_span_ms.caption": ("beam.step", 1e-6),
           "decode_step_span_ms.caption_device": ("beam.step", 1e-6),
           "decode_host_ms.caption": ("beam.issue", 1e-6),
           "decode_host_ms.caption_device": ("beam.issue", 1e-6),
           "upload_ms.caption": ("predict.upload", 1e-6),
           "upload_ms.caption_device": ("predict.upload", 1e-6),
           "train_host_ms": ("train.issue", 1e-6),
           "pipeline_init_s": ("pipeline.init", 1e-9)}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_readers(metric, monkeypatch):
    """None on a program without spans, and with no such span; else the
    median of the spans recorded, in the metric's unit (for the host's time,
    each span less its waits for the card)."""
    spec = importlib.util.spec_from_file_location(f"reader_{metric}", METRICS / f"{metric}.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    assert reader.read({}) is None
    with monkeypatch.context() as m:
        m.delattr(profiling, "REGISTRY")
        assert reader.read({}) is None
    span, unit = READERS[metric]
    start = profiling._clock()
    REGISTRY.record(span + ".other", start, start + 10**9)
    assert reader.read({}) is None
    for ns in (3_000_000, 1_000_000, 2_000_000, 50_000_000):
        REGISTRY.record(span, start, start + ns)
    value = reader.read({})
    assert isinstance(value, float) and value == pytest.approx(2_500_000 * unit)
    if "host" in metric:
        REGISTRY.reset()
        start = profiling._clock()
        for ns, wait in ((3, 2), (1, 0.5), (2, 0.5), (50, 1)):
            REGISTRY.add(span, start, start + int(ns * 1e6), wait_ns=int(wait * 1e6))
        assert reader.read({}) == pytest.approx(1.25)   # of 1, 0.5, 1.5 and 49 ms
