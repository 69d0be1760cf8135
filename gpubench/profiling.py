"""One CUDA-profiler window over a few calls: the device's busy time, the
device operations that took the most time, and the idle gaps between them
named by what the host was doing. The window runs the calls twice and keeps
the second run (the profiler's warm-up step absorbs what tracing misses
while it starts), and a window in which the profiler saw no device time is
run again, up to three times."""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _window(fn, path: str) -> float:
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    return wall


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def summarize(events: list[dict], wall_s: float, name_gaps: bool = True) -> dict:
    """Busy seconds (the union of the device's operations), the ten device
    operations with the most time, and (``name_gaps``) the ten host
    operations under which the device sat idle longest (a gap between two
    device operations is named by the innermost host operation that spans
    its middle; this search is slow over many calls)."""
    dev = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"), key=lambda r: r[0])
    host = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
            if e.get("cat") in ("cpu_op", "cuda_runtime", "cuda_driver") and e.get("ph") == "X"]
    by_op: dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        by_op[name] += (b - a) / 1e6
    gaps: dict[str, float] = defaultdict(float)
    end = dev[0][1] if dev else 0.0
    for a, b, _ in dev[1:] if name_gaps else ():
        if a > end:
            mid = (a + end) / 2
            spans = [h for h in host if h[0] <= mid <= h[1]]
            name = min(spans, key=lambda h: h[1] - h[0])[2] if spans else "host (no operation)"
            gaps[name] += (a - end) / 1e6
        end = max(end, b)
    top = lambda d: [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": _union((a, b) for a, b, _ in dev) / 1e6, "wall_s": wall_s,
            "device_ops": top(by_op), "idle_gaps": top(gaps)}


def profile_calls(fn, name_gaps: bool = True) -> dict:
    """``summarize`` of one profiled run of ``fn``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        for _ in range(3):
            wall = _window(fn, path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
            out = summarize(events, wall, name_gaps)
            if out["busy_s"] > 0:
                return out
    raise RuntimeError("the CUDA profiler recorded no device time in three windows")
