"""What a launch of a hand-written kernel costs against the same work as plain
PyTorch, and the inverted-residual block as cuDNN convs beside the port's
fused kernel: the counterpart of the TPU probe
``scripts/probe_pallas_overhead.py``.

(a) A chain of n ``add_one`` launches on a (256, 256) float32 tensor
    (``chain``, the TPU's ``chain_pallas``) against the chain of ``x + 1``
    in PyTorch (``chain_plain``, the TPU's ``chain_xla``), n = 1, 8, 32;
    per-launch overhead ``(t_kernel - t_plain) / n``.
(b) The inverted-residual block at the TPU script's four (H, C, T, Cout, S)
    configurations, batch 64 bf16 zeros: expand 1×1, relu6, depthwise 3×3
    at stride S, relu6, project 1×1 as cuDNN convs in ``channels_last``,
    and ``ops.fused_backbone.fused_ir_block`` at the same shape; each beside
    its operations per second and the H100's bounds (3.35 TB/s, 989 TFLOP/s
    bf16), the minimal traffic (input and output once) and the unfused one
    (every intermediate once).

Host times are wall clock over 20 calls, each waited for; device times are
the CUDA profiler's per call.

    python -m fpn_mt_image_captioning_torch.scripts.probe_pallas_overhead [--device=cpu]
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F

from ..ops import fused_backbone as fb
from ..ops import probes as pr
from ._common import (BF16_FLOPS, HBM_BYTES_PER_S, PROFILED_RUNS, device_from_argv, device_rows,
                      total, wall)

CHAIN_NS = (1, 8, 32)
IR_CONFIGS = ((256, 16, 6, 24, 2), (128, 24, 6, 32, 2), (64, 32, 6, 64, 2), (128, 24, 6, 24, 1))
IR_BATCH = 64
ITERS = 20


def chain(x, n: int):
    """n ``add_one`` launches, then the sum (the TPU's ``chain_pallas``)."""
    for _ in range(n):
        x = pr.add_one(x)
    return x.sum()


def chain_plain(x, n: int):
    """The same work as PyTorch's own ``x + 1`` (the TPU's ``chain_xla``)."""
    for _ in range(n):
        x = x + 1.0
    return x.sum()


def ir_operands(h: int, c: int, t: int, cout: int, batch: int, device):
    """Zero bf16 operands of one block: NCHW ``channels_last`` input and conv
    weights for cuDNN, NHWC input and packed weights for ``fused_ir_block``."""
    bf, cl = torch.bfloat16, torch.channels_last
    z = lambda *s, dt=bf: torch.zeros(s, dtype=dt, device=device)
    cudnn = (z(batch, c, h, h).to(memory_format=cl), z(c * t, c, 1, 1).to(memory_format=cl),
             z(c * t, 1, 3, 3).to(memory_format=cl), z(cout, c * t, 1, 1).to(memory_format=cl))
    f32 = torch.float32
    blk = {"w_exp": z(c, c * t), "b_exp": z(c * t, dt=f32), "w_dw": z(9, c * t, dt=f32),
           "b_dw": z(c * t, dt=f32), "w_proj": z(c * t, cout), "b_proj": z(cout, dt=f32)}
    return cudnn, (z(batch, h, h, c), blk)


def ir_block_cudnn(x, we, wd, wp, s: int):
    """The block as three convs (padding 1: the TF-SAME shapes of the TPU
    probe's convs; on zeros the time does not depend on which side pads)."""
    h = F.relu6(F.conv2d(x, we))
    h = F.relu6(F.conv2d(h, wd, stride=s, padding=1, groups=wd.shape[0]))
    return F.conv2d(h, wp).sum()


def ir_block_fused(x, blk, s: int):
    return fb.fused_ir_block(x, blk, stride=s, residual=False).sum()


def ir_costs(h, c, t, cout, s, batch) -> dict:
    """Operations, minimal and unfused bytes of one block (the TPU script's
    formulas) and the H100's bounds in ms."""
    flops = 2 * batch * h * h * (c * c * t + 9 * c * t / (s * s) + c * t * cout / (s * s))
    minimal = batch * h * h * 2 * (c + cout / (s * s))
    unfused = batch * h * h * 2 * (c + c * t + c * t / (s * s) + cout / (s * s))
    return dict(flops=flops, minimal_bytes=minimal, unfused_bytes=unfused,
                bound_ms=1e3 * max(minimal / HBM_BYTES_PER_S, flops / BF16_FLOPS),
                minimal_traffic_ms=1e3 * minimal / HBM_BYTES_PER_S,
                unfused_traffic_ms=1e3 * unfused / HBM_BYTES_PER_S)


def _timed(fn, device, launches: int | None = None, kernel: str = "") -> dict:
    """Host ms of one call of ``fn`` over ITERS calls and, on the card, its
    device ms; the profiler window must hold ``launches`` launches of
    ``kernel`` (``device_rows``)."""
    row = {"host_ms": 1e3 * wall(fn, device, runs=ITERS)}
    rows, windows = device_rows(fn, device, launches, kernel)
    if rows is not None:
        us, n = total(rows)
        row.update(device_ms=us / 1e3, launches=n, profiler_windows=windows)
    return row


def measure(device=None) -> dict:
    """(a) for each n of CHAIN_NS and (b) for each of IR_CONFIGS at batch
    IR_BATCH, each timed over ITERS calls."""
    device = torch.device(device) if device is not None else device_from_argv([])[0]
    x = torch.zeros((256, 256), dtype=torch.float32, device=device)
    chains = {}
    for n in CHAIN_NS:
        k = _timed(lambda: chain(x, n), device, n, "add_one")
        p = _timed(lambda: chain_plain(x, n), device)
        chains[n] = {"kernel": k, "plain": p,
                     "host_overhead_us_per_launch": 1e3 * (k["host_ms"] - p["host_ms"]) / n}
    blocks = {}
    for h, c, t, cout, s in IR_CONFIGS:
        (xc, we, wd, wp), (xn, blk) = ir_operands(h, c, t, cout, IR_BATCH, device)
        costs = ir_costs(h, c, t, cout, s, IR_BATCH)
        row = {"cudnn": _timed(lambda: ir_block_cudnn(xc, we, wd, wp, s), device),
               "fused_ir_block": _timed(lambda: ir_block_fused(xn, blk, s), device, 1,
                                        "ir_block"),
               **costs}
        for route in ("cudnn", "fused_ir_block"):
            if "device_ms" in row[route]:
                row[route]["tflops"] = costs["flops"] / row[route]["device_ms"] / 1e9
        blocks[f"IR {h}x{h}x{c} t{t}->{cout} s{s}"] = row
    return {"chains": chains, "ir_blocks": blocks, "ir_batch": IR_BATCH}


def expected_launches(results: dict) -> dict:
    """Launches of each kernel wrapper in the ``measure()`` on the card that
    gave ``results``: ``_timed`` runs its function 1 + ITERS times by the
    wall clock and PROFILED_RUNS times in each profiler window."""
    calls = lambda row: 1 + ITERS + PROFILED_RUNS * row["profiler_windows"]
    return {pr.add_one: sum(n * calls(row["kernel"]) for n, row in results["chains"].items()),
            fb.fused_ir_block: sum(calls(row["fused_ir_block"])
                                   for row in results["ir_blocks"].values())}


def main(argv=None) -> int:
    device, _ = device_from_argv(sys.argv[1:] if argv is None else argv)
    r = measure(device)
    for n, row in r["chains"].items():
        print(f"n={n:3d}: kernel {row['kernel']['host_ms']:7.3f} ms, plain "
              f"{row['plain']['host_ms']:7.3f} ms, per-launch overhead "
              f"~{row['host_overhead_us_per_launch']:7.1f} us", flush=True)
    for name, row in r["ir_blocks"].items():
        times = ", ".join(f"{route} {row[route].get('device_ms', row[route]['host_ms']):7.3f} ms"
                          f"{'' if 'device_ms' in row[route] else ' (host)'}"
                          for route in ("cudnn", "fused_ir_block"))
        print(f"{name}: {times}; bound {row['bound_ms']:.3f} ms, unfused traffic "
              f"{row['unfused_traffic_ms']:.3f} ms", flush=True)
    print(json.dumps({"device": str(device), "pallas_overhead": r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
