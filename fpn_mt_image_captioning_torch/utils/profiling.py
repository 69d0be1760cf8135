"""Profiling and timing (port of ``fpn_mt_image_captioning_tpu/utils/profiling.py``):

  * ``annotate(name, cpu=False, wait=False)`` — a named span, the port's
    only one. With
    no profiler running it reads the host clock at its enter and exit and
    counts the span into ``REGISTRY``: no ``record_function``, no NVTX, no
    device call, no synchronisation. Under an active ``torch.profiler``
    (``torch.autograd._profiler_enabled()``) it is a ``record_function``
    range instead: a ``user_annotation`` event on the trace's clock, and an
    NVTX range under ``emit_nvtx``; nothing enters the registry then (the
    profiler slows the host). While ``torch.export`` traces it does nothing,
    so an exported program holds no trace of it;
  * ``REGISTRY`` — the process' spans (a ``SpanRegistry``): for each name a
    count, total, self and wait time since the last ``reset``, and a ring of
    the latest durations; ``summary(name)`` gives ``steps``, ``mean_ms``,
    ``p50_ms``, ``p90_ms``, ``p99_ms`` and ``self_ms``, ``cpu_ms`` for spans
    that take the thread's CPU time, and ``wait_ms`` and ``host_p50_ms``
    for spans in which the host waited for the card. The server's
    ``/stats`` and the benchmark's per-layer readers (``gpubench/
    metrics/``) read it;
  * ``trace(logdir)`` — a ``torch.profiler`` trace (CPU and, on the card,
    CUDA activities) of the block it wraps, written into ``logdir`` by
    ``tensorboard_trace_handler`` (``*.pt.trace.json``, a Chrome trace that
    TensorBoard's PyTorch profiler plugin and Perfetto read); the spans lie
    in it as ``user_annotation`` events;
  * ``StepTracer`` — the ``--profile_dir`` surface of the ``train`` main: a
    ``trace`` over a window of training steps;
  * ``sync`` — wait for the card's work on the tensors of a tree;
  * ``cuda_kernel_times`` — the card's own time of each kernel of a call
    (the probe scripts and the smoke).

The spans of the port, by layer (each nested in the one above it):
``pipeline.init`` (``Pipeline.__init__``); ``predict.call`` (a call of
``Pipeline.predict_batch``, with CPU time) over ``predict.upload`` (the
images to the device), ``predict.encode``, one ``beam.step`` a step of the
beam search (the stop test ``beam.sync`` where one is due, then
``beam.issue``: the expansion, whose decode step is ``beam.kernels``, and
the loop's bookkeeping; on the CUDA-graph route ``beam.kernels`` is the
step's replay, ``beam.replay``, and each graph captured is a
``beam.capture``) and ``predict.to_host``; ``train.step`` (a call of
``Pipeline.train_step``, with CPU time) over ``train.issue``
(``train.upload``, ``train.forward``, ``train.backward``, ``train.clip``,
whose wait for the gradients' scales is ``train.clip.wait``, and
``train.optimizer``) and ``train.readback`` (the loss to the host); the
server's ``serve.batch`` (a device batch, with CPU time) and
``serve.queue_wait`` (a request, from its arrival until its batch is
taken); inside the encoder and the decoder, ``model.pe_upload`` (a
positional-encoding table copied to the card). The waits for the card:
``beam.sync``, ``predict.to_host``, ``train.clip.wait``,
``train.readback`` and ``model.pe_upload`` (a copy from host memory waits
for the work queued before it).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any

import numpy as np
import torch

__all__ = ["trace", "annotate", "SpanRegistry", "REGISTRY", "StepTracer", "sync",
           "cuda_kernel_times"]

_profiling = torch.autograd._profiler_enabled
_exporting = getattr(torch.compiler, "is_exporting", lambda: False)
_clock = time.perf_counter_ns
_cpu_clock = time.thread_time_ns
_open = threading.local()   # .stack: the open spans of a thread, innermost last


class _Stat:
    __slots__ = ("since", "count", "total_ns", "self_ns", "wait_ns", "cpu_ns", "ring", "host")

    def __init__(self, since: int, ring: int):
        self.since = since   # a span that began before this is left out
        self.count = self.total_ns = self.self_ns = self.wait_ns = 0
        self.cpu_ns = None   # spans with CPU time only
        self.ring = collections.deque(maxlen=ring)   # durations
        self.host = collections.deque(maxlen=ring)   # durations less their waits


class SpanRegistry:
    """The spans of a process, kept in memory; safe to use from any thread.

    Per name: the count, total, self, wait and (where taken) thread CPU time
    of the spans since the last ``reset`` of the name, and rings of the
    latest ``ring`` durations, with and without their waits. A span that
    began before that reset is left out: a call in flight across a reset
    does not count into the fresh window."""

    def __init__(self, ring: int = 4096):
        self.ring = ring
        self._lock = threading.Lock()
        self._stats: dict[str, _Stat] = {}
        self._resets: dict[str, int] = {}   # name prefix -> its last reset

    def add(self, name: str, start_ns: int, end_ns: int, self_ns: int | None = None,
            cpu_ns: int | None = None, wait_ns: int = 0) -> None:
        """Count a span, from ``start_ns`` to ``end_ns`` on
        ``time.perf_counter_ns``; ``self_ns`` is the part its child spans do
        not cover (all of it by default), ``wait_ns`` the part the host
        waited for the card."""
        dur = end_ns - start_ns
        lock = self._lock
        lock.acquire()   # not ``with``: half its cost, in a span's own path
        try:
            st = self._stats.get(name)
            if st is None:
                since = max((t for p, t in self._resets.items() if name.startswith(p)),
                            default=0)
                st = self._stats[name] = _Stat(since, self.ring)
            if start_ns >= st.since:
                st.count += 1
                st.total_ns += dur
                st.self_ns += dur if self_ns is None else self_ns
                st.wait_ns += wait_ns
                st.ring.append(dur)
                st.host.append(dur - wait_ns)
                if cpu_ns is not None:
                    st.cpu_ns = (st.cpu_ns or 0) + cpu_ns
        finally:
            lock.release()

    def record(self, name: str, start_ns: int, end_ns: int) -> None:
        """A span timed outside a ``with`` block (on ``time.perf_counter_ns``),
        counted as ``annotate`` counts one: not under a profiler, not while
        ``torch.export`` traces."""
        if not (_exporting() or _profiling()):
            self.add(name, start_ns, end_ns)

    def reset(self, *prefixes: str) -> None:
        """Forget the spans whose names start with one of ``prefixes`` (every
        span without any), and those of them still open."""
        prefixes = prefixes or ("",)
        with self._lock:
            now = _clock()
            if "" in prefixes:
                self._resets.clear()
            for p in prefixes:
                self._resets[p] = now
            for name in self._stats:
                if name.startswith(prefixes):
                    self._stats[name] = _Stat(now, self.ring)

    def names(self) -> list[str]:
        """The names with spans since their last reset."""
        with self._lock:
            return sorted(name for name, st in self._stats.items() if st.count)

    def summary(self, name: str) -> dict:
        """``{}`` before the first span of ``name``; else ``steps`` (the count
        since the last reset), ``mean_ms`` and ``self_ms`` (the means since
        then), ``p50_ms``/``p90_ms``/``p99_ms`` (over the latest ``ring``
        spans), ``cpu_ms`` (the mean thread CPU time) where it is taken, and
        where the host waited for the card in such spans, ``wait_ms`` (the
        mean wait) and ``host_p50_ms`` (the median duration less its wait)."""
        with self._lock:
            st = self._stats.get(name)
            if st is None or not st.count:
                return {}
            count, total, self_ns, wait_ns, cpu_ns, ring, host = (
                st.count, st.total_ns, st.self_ns, st.wait_ns, st.cpu_ns, list(st.ring),
                list(st.host))
        p50, p90, p99 = np.percentile(np.asarray(ring, np.float64), (50, 90, 99)) / 1e6
        out = {"mean_ms": total / count / 1e6, "p50_ms": float(p50), "p90_ms": float(p90),
               "p99_ms": float(p99), "steps": count, "self_ms": self_ns / count / 1e6}
        if cpu_ns is not None:
            out["cpu_ms"] = cpu_ns / count / 1e6
        if wait_ns:
            out["wait_ms"] = wait_ns / count / 1e6
            out["host_p50_ms"] = float(np.median(np.asarray(host, np.float64))) / 1e6
        return out


REGISTRY = SpanRegistry()


class annotate:
    """A named span over a ``with`` block (see the module's docstring).

    ``cpu=True`` also takes the thread's CPU time (the call-level spans: a
    ``predict_batch``, a ``train_step``, a server batch). ``wait=True``
    marks a span in which the host waits for the card (a synchronisation):
    its time is wait time of every span around it on the same thread. A
    span's self time is its duration less the part its child spans of the
    same thread cover. A span that an exception ends is not counted (a
    failed call's time is no call's time)."""

    __slots__ = ("name", "cpu", "wait", "start_ns", "child_ns", "wait_ns", "cpu_ns", "_range",
                 "_stack")

    def __init__(self, name: str, cpu: bool = False, wait: bool = False):
        self.name = name
        self.cpu = cpu
        self.wait = wait

    def __enter__(self) -> "annotate":
        if _exporting():
            self._range = False
        elif _profiling():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        else:
            self._range = None
            try:
                stack = self._stack = _open.stack
            except AttributeError:
                stack = self._stack = _open.stack = []
            self.child_ns = self.wait_ns = 0
            if self.cpu:
                self.cpu_ns = _cpu_clock()
            stack.append(self)
            self.start_ns = _clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._range is None:
            end = _clock()
            cpu = _cpu_clock() - self.cpu_ns if self.cpu else None
            stack = self._stack
            stack.pop()
            dur = end - self.start_ns
            wait = dur if self.wait else self.wait_ns
            if stack:
                parent = stack[-1]
                parent.child_ns += dur
                parent.wait_ns += wait
            # left out too: a span inside which a profiler started
            if exc_type is None and not _profiling():
                REGISTRY.add(self.name, self.start_ns, end, dur - self.child_ns, cpu, wait)
        elif self._range:
            self._range.__exit__(exc_type, exc, tb)


def _profiler(logdir: str):
    """A ``torch.profiler.profile`` of the CPU and, where there is one, the
    card, that writes its trace into ``logdir`` when it stops."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir))


@contextlib.contextmanager
def trace(logdir: str = "logs/profile"):
    """Trace the block into ``logdir`` (a ``*.pt.trace.json`` file)."""
    prof = _profiler(logdir)
    prof.start()
    try:
        yield logdir
    finally:
        sync_all()
        prof.stop()


class StepTracer:
    """The ``--profile_dir`` surface: a trace over a window of training steps.

    Call ``step(i)`` once a step with a running index; the trace opens at
    ``start`` (default 1, so the first step's kernel builds and allocations
    stay out of it) and closes at ``stop``, and the trace file is written
    then. ``close()`` is idempotent and ends an open trace early (a run with
    fewer steps than the window)."""

    def __init__(self, logdir: str, start: int = 1, stop: int = 4):
        self.logdir = logdir
        self.start = start
        self.stop = stop
        self._prof = None
        self._done = False

    def step(self, i: int) -> None:
        if self._done:
            return
        if self._prof is None and i >= self.start:
            self._prof = _profiler(self.logdir)
            self._prof.start()
        elif self._prof is not None and i >= self.stop:
            self.close()

    def close(self) -> None:
        if self._prof is not None:
            sync_all()
            self._prof.stop()
            self._prof = None
        self._done = True


def sync_all() -> None:
    """Wait for all work queued on the current card (no-op without one)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def sync(tree: Any) -> None:
    """Wait until the card has computed the tensors of ``tree`` (nested
    dicts, lists and tuples): ``torch.cuda.synchronize`` on each card they
    lie on; a no-op for CPU tensors."""
    for dev in {t.device for t in _leaves(tree) if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def cuda_kernel_times(fn) -> tuple[list[tuple[str, float, int]], float]:
    """``(kernel name, device µs, launches)`` of every kernel and copy that
    ``fn`` ran on the card, and the wall ms of ``fn``, from one CUDA-profiler
    window. The window runs ``fn`` twice and keeps the second run: the
    profiler's warm-up step absorbs what tracing misses while it starts."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        prof.step()
    return ([(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
             if e.self_device_time_total > 0], wall_ms)
