"""Timing helpers: the port's copy of ``StepTimer`` from
``fpn_mt_image_captioning_tpu/utils/profiling.py``, which the server uses,
and ``cuda_kernel_times``, the card's own time of each kernel from the CUDA
profiler, which the probe scripts use. The JAX profiler wrappers of that
module are not ported; the port traces the card with ``torch.profiler``."""

from __future__ import annotations

import time

import numpy as np

__all__ = ["StepTimer", "cuda_kernel_times"]


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
    """Rolling wall-clock timer for serving (and later training) steps."""

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
