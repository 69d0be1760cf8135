"""Profiling and timing (port of ``fpn_mt_image_captioning_tpu/utils/profiling.py``):

  * ``trace(logdir)`` — a ``torch.profiler`` trace (CPU and, on the card,
    CUDA activities) of the block it wraps, written into ``logdir`` by
    ``tensorboard_trace_handler`` (``*.pt.trace.json``, a Chrome trace that
    TensorBoard's PyTorch profiler plugin and Perfetto read);
  * ``annotate(name)`` — a named span: ``record_function`` in the trace, and
    an NVTX range on the card;
  * ``StepTracer`` — the ``--profile_dir`` surface of the ``train`` main: a
    ``trace`` over a window of training steps;
  * ``sync`` — wait for the card's work on the tensors of a tree;
  * ``build_train_run`` / ``train_step_slope`` — n optimizer steps of the
    real train step, and the training throughput from K and 2K of them;
  * ``StepTimer`` — host-side rolling step timing (the server's);
  * ``cuda_kernel_times`` — the card's own time of each kernel of a call
    (the probe scripts and the smoke).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import numpy as np

__all__ = ["trace", "annotate", "StepTracer", "sync", "train_step_slope", "build_train_run",
           "StepTimer", "cuda_kernel_times"]


def _profiler(logdir: str):
    """A ``torch.profiler.profile`` of the CPU and, where there is one, the
    card, that writes its trace into ``logdir`` when it stops."""
    import torch
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


@contextlib.contextmanager
def annotate(name: str):
    """A named span: ``record_function`` inside an active trace, and an NVTX
    range on the card (what ``nsys`` shows)."""
    import torch

    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield


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
    import torch

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
    import torch

    for dev in {t.device for t in _leaves(tree) if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def build_train_run(model, *, batch: int, seq_len: int, image_size: int, vocab: int,
                    schedule_dim: int = 2048, seed: int = 0, dropout_rate: float = 0.1):
    """The n-step training runner that ``train_step_slope`` times.

    ``model``: a float32 ``Transformer`` on its device, trained IN PLACE.
    Returns ``(run, state, img, caps)``: seeded images (B, S, S, 3) and
    caption ids (B, seq_len) on the model's device, the ``TrainState``, and
    ``run(state, img, caps, n) → (state, loss_sum)``, which takes n optimizer
    steps of ``build_train_step_fn``'s step (the production step: loss,
    gradients, per-variable clipping, AMSGrad, BatchNorm statistics, dropout
    drawn from the step) and sums their losses on the device: the sum is an
    output, so no step's work can be left out."""
    import torch

    from ..train.pipeline import TrainState, build_train_step_fn
    from ..train.schedule import custom_schedule, keras_adam_init

    dev = next(model.parameters()).device
    state = TrainState(model, keras_adam_init(list(model.parameters())), 0)
    rng = np.random.default_rng(seed)
    img = torch.as_tensor(
        rng.standard_normal((batch, image_size, image_size, 3), dtype=np.float32) * 0.5,
        device=dev)
    caps = torch.as_tensor(rng.integers(1, max(vocab - 1, 2), size=(batch, seq_len)),
                           dtype=torch.long, device=dev)
    step_fn = build_train_step_fn(custom_schedule(schedule_dim, 4000), seed=seed,
                                  dropout_rate=dropout_rate)

    def run(state, img, caps, n: int):
        acc = torch.zeros((), device=img.device)
        for _ in range(n):
            state, loss = step_fn(state, img, caps)
            acc = acc + loss
        return state, acc

    return run, state, img, caps


def train_step_slope(model, *, batch: int, seq_len: int, image_size: int, vocab: int, k: int,
                     schedule_dim: int = 2048, seed: int = 0) -> dict:
    """Training throughput from the slope: K and then 2K optimizer steps of
    ``build_train_run``'s runner, each timed to the read-back of its loss
    sum (which waits for the card), and ``(t(2K) − t(K)) / K`` a step, so the
    fixed cost of a call cancels. One step runs first (kernel builds,
    allocator). ``model`` (float32, on its device) is trained in place."""
    run, state, img, caps = build_train_run(
        model, batch=batch, seq_len=seq_len, image_size=image_size, vocab=vocab,
        schedule_dim=schedule_dim, seed=seed)

    def t(n):
        nonlocal state
        sync(img)
        t0 = time.perf_counter()
        state, acc = run(state, img, caps, n)
        float(acc)
        return time.perf_counter() - t0

    t(1)
    t1, t2 = t(k), t(2 * k)
    step_ms = max((t2 - t1) / k, 1e-9) * 1000
    return {"images_per_sec": batch / (step_ms / 1000), "step_ms": step_ms, "batch": batch}


def cuda_kernel_times(fn) -> tuple[list[tuple[str, float, int]], float]:
    """``(kernel name, device µs, launches)`` of every kernel and copy that
    ``fn`` ran on the card, and the wall ms of ``fn``, from one CUDA-profiler
    window. The window runs ``fn`` twice and keeps the second run: the
    profiler's warm-up step absorbs what tracing misses while it starts."""
    import torch
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


class StepTimer:
    """Rolling wall-clock timer for serving steps."""

    def __init__(self, window: int = 200):
        self.window = window
        self.times: list[float] = []
        self._t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        """Record the time since ``start``. The caller waits for the device
        first (``predict_batch`` returns host arrays)."""
        if self._t0 is None:
            # recording ~0 ms would drag the window's percentiles down with
            # garbage samples: an unpaired stop is a caller bug
            raise RuntimeError("StepTimer.stop() without a matching start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    def summary(self) -> dict:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_ms": float(arr.mean() * 1000),
            "p50_ms": float(np.percentile(arr, 50) * 1000),
            "p90_ms": float(np.percentile(arr, 90) * 1000),
            "p99_ms": float(np.percentile(arr, 99) * 1000),
            "steps": len(arr),
        }
