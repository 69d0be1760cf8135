"""Where the time of ``decoder_linear``'s wgmma kernel goes, CTA by CTA, at
the decode step's linear shapes (d 512, dff 2048, vocabulary 2000, bf16, at
512 and 64 rows):

    python -m fpn_mt_image_captioning_torch.scripts.linear_phases [--all_plans]

It launches the kernel from the ``fused_decoder_phases`` build of
``csrc/fused_decoder.cu`` (``-DFD_PHASE_TIMES``: thread 0 of every CTA
stamps the SM clock as each phase ends, and the global timer at entry and
end), on the plan ``linear_plan`` picks, or with ``--all_plans`` on every
tile height and split that keeps the CTAs within four an SM. It prints one
JSON line: per shape and plan the median and the largest time of each phase
over the CTAs in ns, the CTAs' start skew and the span from the first start
to the last end, with the card's name and power limit. These times stand in
for a stall profile where no Nsight Compute is at hand. Needs a CUDA card."""

from __future__ import annotations

import ctypes
import importlib.util
import json
import statistics
import subprocess
import sys

import torch

from fpn_mt_image_captioning_torch.ops import fused_decoder as fd

D, DFF, V = 512, 2048, 2000
SHAPES = (("qkv", D, 3 * D, "none", False), ("out", D, D, "none", True),
          ("ffn1", D, DFF, "leaky_relu", False), ("ffn2", DFF, D, "none", True),
          ("vocab", D, V, "none", True))
# phase: (stamp it starts at, stamp it ends at); stamps 4-6 exist with a split
PHASES = {"setup": (0, 1), "first_slice": (1, 2), "k_loop": (2, 3), "cluster_wait": (3, 4),
          "exchange": (4, 5), "reduce": (5, 6), "epilogue": (6, 7), "total": (0, 7)}


def phases_decoder():
    """A second instance of ``ops/fused_decoder.py`` on the phase-stamping
    build, with the entry point that reads the stamps."""
    spec = importlib.util.find_spec(fd.__name__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.LIBRARY = "fused_decoder_phases"
    lib = mod._lib()
    lib.fd_phase_times.argtypes, lib.fd_phase_times.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    return mod


def phase_times(mod, x, w, b, act, out_f32, plan) -> dict:
    """One launch's phases over its CTAs (after a warm-up launch)."""
    for _ in range(2):
        mod.decoder_linear(x, w, b, act, out_f32, plan=plan)
    torch.cuda.synchronize()
    n = plan.split * plan.grid_n * plan.grid_m
    buf = (ctypes.c_longlong * (10 * n))()
    rc = mod._lib().fd_phase_times(ctypes.addressof(buf), n)
    if rc:
        raise RuntimeError(f"fd_phase_times: {mod._error_string(rc).decode()}")
    ctas = [buf[10 * i:10 * i + 10] for i in range(n)]
    ns_per_clock = statistics.median((c[9] - c[8]) / (c[7] - c[0]) for c in ctas)
    out = {}
    for name, (a, z) in PHASES.items():
        if name == "epilogue" and plan.split == 1:
            a = 3                       # no cluster phases: the epilogue follows the K loop
        ns = [(c[z] - c[a]) * ns_per_clock for c in ctas if c[a] and c[z]]
        if ns:
            out[name] = [round(statistics.median(ns)), round(max(ns))]
    starts, ends = [c[8] for c in ctas], [c[9] for c in ctas]
    return {"plan": plan._asdict(), "ctas": n, "phases_ns_median_max": out,
            "start_skew_ns": max(starts) - min(starts), "span_ns": max(ends) - min(starts)}


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise SystemExit("linear_phases: needs a CUDA card")
    all_plans = "--all_plans" in argv
    mod, dev = phases_decoder(), torch.device("cuda", 0)
    g = torch.Generator().manual_seed(0)
    result = {}
    for m in (512, 64):
        for name, k, n, act, out_f32 in SHAPES:
            x = torch.randn(m, k, generator=g).to(dev, torch.bfloat16)
            w = (torch.randn(k, n, generator=g) * k ** -0.5).to(dev, torch.bfloat16)
            b = torch.randn(n, generator=g).to(dev)
            plans = [fd.linear_plan(m, n, k)]
            if all_plans:
                for bm in (64, 128):
                    for split in (1, 2, 4, 8):
                        try:
                            p = fd.linear_plan(m, n, k, bm=bm, split=split)
                        except ValueError:
                            continue
                        if p not in plans and p.split * p.grid_n * p.grid_m <= 4 * fd.H100_SMS:
                            plans.append(p)
            result[f"{name}_M{m}"] = {f"bm{p.bm}_split{p.split}": phase_times(
                mod, x, w, b, act, out_f32, p) for p in plans}
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
