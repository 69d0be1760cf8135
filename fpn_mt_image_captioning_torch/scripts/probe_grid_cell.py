"""How fast the card moves the backbone's image patch from device memory into
shared memory, for each layout the TPU probe tried and each copy mechanism
Hopper has: the counterpart of the TPU probe ``scripts/probe_grid_cell.py``.

x is (B, Hp, Wp, C) = (64, 258, 272, 32) bf16, the bordered NHWC layout of
the backbone's first blocks. Grid cell (b, i) takes rows 1 + i·64 … + 64 of
item b into shared memory, doubles them and writes them back (rows 0 and 257
stay unwritten), in chunks of about 70 KB (``ops/probes.py``):

  A  4D ds-batch     TMA over a rank-4 (C, Wp, Hp, B) tensor map
  B  3D fold-batch   TMA over a rank-3 (C, Wp, B·Hp) map
  C  4D lane128      x padded to 128 channels in the call, then as A
  D  2D flat         TMA over a rank-2 (C, B·Hp·Wp) map
  D 2D flat loads    layout D through plain 16-byte loads
  D 2D flat cp.async layout D through 16-byte cp.async, two stages

Per variant: host ms per call by the slope over k = 8 and 16 calls, µs per
grid cell, and on the card the device ms per call (CUDA profiler) and the
rate in GB/s of the bytes the call must move (its rows read once, written
once) against the H100's 3.35 TB/s.

    python -m fpn_mt_image_captioning_torch.scripts.probe_grid_cell [--device=cpu]
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import probes as pr
from ._common import HBM_BYTES_PER_S, device_from_argv, device_rows, slope, slope_links, total

B, HP, WP, C = 64, 258, 272, 32
ROWS = 64
N_TILES = 256 // ROWS
K = 8

# name, wrapper, output channels (None: C)
VARIANTS = (("A 4D ds-batch", pr.slab_copy_4d, None), ("B 3D fold-batch", pr.slab_copy_3d, None),
            ("C 4D lane128", pr.slab_copy_lane128, pr.LANES),
            ("D 2D flat", pr.slab_copy_flat, None),
            ("D 2D flat loads", pr.slab_copy_flat_loads, None),
            ("D 2D flat cp.async", pr.slab_copy_flat_cp_async, None))


def slab_bytes(c_out: int | None) -> int:
    """Bytes one call must move: the slab rows of x read once, the same rows
    of the output (``c_out`` channels, C if None) written once."""
    return B * ROWS * N_TILES * WP * (C + (c_out or C)) * 2


def run_variant(call, x, c_out: int | None) -> dict:
    device, k = x.device, K

    def make(n):
        def run():
            for _ in range(n):
                y = call(x, ROWS, N_TILES)
            return y

        return run

    per_call = slope(make, k, device)
    row = {"host_ms_per_call": 1e3 * per_call,
           "host_us_per_cell": 1e6 * per_call / (B * N_TILES)}
    rows, windows = device_rows(make(k), device, k, "slab_")
    if rows is not None:
        ms = total(rows)[0] / 1e3 / k
        row.update(device_ms_per_call=ms, kernel_ms=total(rows, "slab_")[0] / 1e3 / k,
                   profiler_windows=windows,
                   gb_per_s=slab_bytes(c_out) / ms / 1e6,
                   share_of_hbm_rate=slab_bytes(c_out) / (ms / 1e3) / HBM_BYTES_PER_S)
    return row


def measure(device=None) -> dict:
    device = torch.device(device) if device is not None else device_from_argv([])[0]
    x = torch.ones((B, HP, WP, C), dtype=torch.bfloat16, device=device)
    return {name: run_variant(call, x, c_out) for name, call, c_out in VARIANTS}


def expected_launches(results: dict) -> dict:
    """Launches of each kernel wrapper in the ``measure()`` on the card that
    gave ``results``."""
    return {call: slope_links(K, results[name]["profiler_windows"])
            for name, call, _ in VARIANTS}


def main(argv=None) -> int:
    device, _ = device_from_argv(sys.argv[1:] if argv is None else argv)
    results = measure(device)
    for name, row in results.items():
        dev = (f", device {row['device_ms_per_call']:7.3f} ms, {row['gb_per_s']:7.1f} GB/s"
               if "device_ms_per_call" in row else ", device not measured")
        print(f"{name:20s} host {row['host_ms_per_call']:7.3f} ms/call "
              f"({row['host_us_per_cell']:6.2f} us/cell){dev}", flush=True)
    print(json.dumps({"device": str(device), "grid_cell": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
