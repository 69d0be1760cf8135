"""Host-side timing helpers (the port's copy of ``StepTimer`` from
``fpn_mt_image_captioning_tpu/utils/profiling.py``, which the server uses).
The JAX profiler wrappers of that module are not ported; the port traces the
card with ``torch.profiler`` (see ``chip_smoke.py``)."""

from __future__ import annotations

import time

import numpy as np

__all__ = ["StepTimer"]


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
