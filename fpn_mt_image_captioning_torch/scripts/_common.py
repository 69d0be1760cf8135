"""What the three probe scripts share: the device from the command line, the
slope of a chain's wall time, the card's time per launch, and how many runs
of a chain these make (so a caller can hold the kernels' launch counts to
what a ``measure()`` launched)."""

from __future__ import annotations

import time

import torch

from ..train.pipeline import resolve_device
from ..utils.profiling import cuda_kernel_times

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12         # dense bf16 tensor-core peak, same source
RUNS = 3                    # timed runs of ``wall`` after its untimed one
PROFILED_RUNS = 2           # ``cuda_kernel_times`` runs its function twice
PROFILER_WINDOWS = 5        # tries of ``device_rows`` at a window that lost launches


def device_from_argv(argv) -> tuple[torch.device, list[str]]:
    """``--device=cpu`` (or another torch device) from ``argv``; without it
    the CUDA card, raising when there is none. Returns the device and the
    other arguments."""
    device, rest = None, []
    for a in argv:
        if a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return resolve_device(device), rest


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall(fn, device: torch.device, runs: int = RUNS) -> float:
    """Seconds per call of ``fn`` by the host's clock, each call waited for,
    after one call that is not timed."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
        sync(device)
    return (time.perf_counter() - t0) / runs


def slope(make, k: int, device: torch.device) -> float:
    """Host seconds per link: ``(t(2k) - t(k)) / k`` for ``make(n)``, a
    nullary runner of a chain of ``n`` links, so what a run costs once (the
    wait for the card, Python's call) cancels."""
    f1, f2 = make(k), make(2 * k)
    return (wall(f2, device) - wall(f1, device)) / k


def slope_links(k: int, windows: int) -> int:
    """Links that ``slope(make, k)`` and then ``device_rows(make(k), ...)``
    run on the card: ``wall`` runs each of the k- and 2k-link chains
    1 + RUNS times, each of the profiler's ``windows`` the k-link chain
    PROFILED_RUNS times."""
    return (1 + RUNS) * 3 * k + PROFILED_RUNS * k * windows


def device_rows(fn, device: torch.device, launches: int | None = None, name_filter: str = ""):
    """``(rows, windows)``: the ``(kernel, device µs, launches)`` rows of one
    run of ``fn`` from the CUDA profiler, and how many profiler windows that
    took; ``(None, 0)`` off the card. A window must record ``launches``
    launches of the kernels whose names hold ``name_filter`` (with None, any
    launch at all); one that recorded fewer lost them (CUPTI drops some at
    times) and is profiled again, up to PROFILER_WINDOWS times; then this
    raises, so no partial count passes for a device time."""
    if device.type != "cuda":
        return None, 0
    seen = []
    for windows in range(1, PROFILER_WINDOWS + 1):
        rows = cuda_kernel_times(fn)[0]
        n = total(rows, name_filter)[1]
        if n == launches or (launches is None and n):
            return rows, windows
        seen.append(n)
    raise RuntimeError(f"the CUDA profiler recorded {seen} launches of kernels named "
                       f"*{name_filter}* in {PROFILER_WINDOWS} windows, not {launches}")


def total(rows, name_filter: str = "") -> tuple[float, int]:
    """(device µs, launches) summed over the rows whose kernel name holds
    ``name_filter``."""
    rows = [r for r in rows if name_filter in r[0]]
    return sum(us for _, us, _ in rows), sum(c for _, _, c in rows)
