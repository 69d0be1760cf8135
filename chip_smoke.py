#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that the
port builds, is right, and captions on the GPU.

    python3 chip_smoke.py

Phases, in the order they run, except that 14 runs between the kernel
checks that open 13 and phase 11 (each prints one line; any failure raises,
so the script exits non-zero without its last line):

  1. environment — the card (nvidia-smi name and power limit), torch and CUDA
     versions; TF32 is switched off for matmuls and convolutions, so float32
     means float32;
  2. build — every CUDA kernel compiled from the sources in this checkout
     (one nvcc per library, started together), and the native image loader
     (g++), which must report itself available;
  3. decode kernels vs plain — each hand-written kernel of the fused decode
     step held to its plain PyTorch version at the flagship decode shapes
     (B·beam = 512, d 512, 8 heads, dff 2048, 6 layers, Lpad 64, vocab
     2000; self-attention at positions 1, 8, 30 and 59, its cache writes
     bitwise equal; cross-attention at Lenc 16 and 64; both again at head
     width 256, d 512 over 2 heads, at position 30 and Lenc 16, and in bf16
     over the 64 rows of a batch of 8, self-attention at 8, 30 and 59 and
     cross-attention at Lenc 16 beside SDPA, with their bounds): float32 at the JAX
     tests' bar (atol 3e-4, ids equal), bfloat16 at |err| <= 1e-2 +
     1e-2·|plain| (one bf16 rounding of the result, 2^-8 relative); with
     each kernel's time beside its plain version's, the one PyTorch call for
     the same function where there is one (for self-attention, SDPA over
     K/V gathered beforehand as a yardstick only: two calls), and its bound;
  4. backbone kernel vs plain — ``fused_ir_block`` (``csrc/fused_backbone.cu``)
     held to ``fused_ir_block_reference`` at every distinct block shape of a
     flagship encode (512², batch 64; blocks 0, 1, 11, 13 and 16 among them),
     float32 at atol 2e-4 + rtol 1e-3 and bfloat16 at 1e-2 + 1e-2·|plain|;
     with its device time, the plain version's, the eager
     ``_InvertedResidual`` block's (cuDNN convs, float32 BatchNorm) and the
     same block on ``channels_last`` tensors as yardsticks, the plan, the
     blocks an SM the card reaches (at least 2 in bfloat16, or it fails), and
     the bound;
  5. whole backbone — the fused backbone against the plain fused backbone on
     8 images: float32 C3/C4 atol 2e-4, C5 2e-3, + rtol 1e-3; in bfloat16,
     where roundings that the summation order flips cascade through 17
     blocks, the kernel route may stray from the float32 result no further
     than the plain route in bfloat16 does (relative L2, 25 % + 1e-3);
  5b. previous designs in turns — the two kernels redesigned for the H100
     against their previous designs (``csrc/previous.cu``, each held to the
     plain version too) on the same inputs, previous, present, present,
     previous: the log-softmax + top-k at 512×2000, top 8, and
     ``fused_ir_block`` in bfloat16 summed over one flagship encode;
  6. probes — the three probe entry points
     (``fpn_mt_image_captioning_torch/scripts/probe_*.py``; kernels in
     ``csrc/probes.cu`` and the decode step's on ``csrc/fused_decoder.cu``
     built with empty bodies) at their full sizes, counters reset just
     before and read just after, each wrapper's count equal to what the
     probes' loops launch (a CUDA-graph capture counts once, a replay not at
     all); one line of slopes, the decoder-shaped step eager against a
     CUDA-graph replay; then each probe kernel held to its plain version,
     exactly (x + 1 and 2·x are exact in their dtypes, the step's result is
     a copy), with its device time, its plain version's, a PyTorch call's
     where one computes the same, and its bound;
  7. whole step — ``fused_decode_step`` held to
     ``fused_decode_step_reference`` over 8 state-synchronised steps (a beam
     reorder, finished rows, the kernel's chosen tokens fed to both); scores
     within atol 3e-4 (float32) / 0.1 (bfloat16), ids equal wherever the
     plain version's neighbouring candidates are further apart than that;
     then the same on the full-width model with 2 heads (head width 256),
     and its ``predict_batch`` of 8 images with counters reset just before
     and read just after, every decode kernel launched;
  8. small input — ``Pipeline.predict_batch`` of a small float32 model on the
     card against the same model on the CPU (plain versions): equal tokens;
  9. main path — ``Pipeline.predict_batch`` at full width (512² uint8 images,
     mobilenet224_1.0, d_model 512, 6+6 layers, dff 2048, 8 heads, beam 8,
     max_seq_len 60, vocab 2000, bfloat16; seeded weights with BatchNorm
     statistics and biases perturbed) on 8 images and then 64 (512 decode
     rows), with ``to_caption``: a warm-up, five timed runs (median wall),
     five timed encodes and one run under the CUDA profiler each; launch
     counters reset just before and read just after, each decode kernel's
     non-zero and equal to the decode steps × its launches per step, the
     backbone kernel's zero (this encode runs cuDNN); each attention
     kernel's mean device time a launch in the traced batch-64 run beside
     its isolated times from phase 3;
 10. fused main path — the same ``predict_batch`` at batch 64 with
     ``fused_backbone=True`` (same weights): counters reset just before and
     read just after, ``fused_ir_block`` at 17 × the encodes; then the fused
     encode against the eager one in turns (eager, fused, fused, eager, five
     times), one traced encode of each, and the whole ``predict_batch`` of
     both routes in turns the same way;
 11. CLI — ``fpn_mt_image_captioning_torch.caption.main`` over a temporary
     directory of 70 PNGs (512², written with zlib and struct) at
     decode_batch 64 (one full batch, one padded): captions equal to
     ``predict_batch`` on the same pixels;
 12. server — ``serve.make_server(port=0)`` in a thread, 8 concurrent POSTs of
     those PNGs: each 200, each caption the CLI's for that file;
 13. evaluate — first the decode kernels at this path's shapes (bf16, beam
     4, 16 items: 64 rows, Lenc 16, top 4), each held to its plain version
     with the tolerances of phases 3 and 7: (c) at positions 1, 8, 30 and 59,
     (d), (e), and ``fused_decode_step`` over 8 steps. Then at full width
     with the evaluation defaults (bf16, beam 4, decode_batch 16), on the
     seeded init perturbed and scaled in the JAX layout so that captions
     depend on the image: a float32 pipeline's ``save_weights`` writes the
     Flax msgpack file bitwise equal to those weights, and
     ``Pipeline.from_config`` reads it (``transformer_weight_path``) into a
     state dict bitwise equal to the one the weights give directly;
     ``evaluate`` over a synthetic COCO split of 40 seeded PNGs, each with
     a colour and a bright band of its own (after a warm-up pass; counters
     reset just before and read just after, each decode kernel at the decode
     steps × its launches a step, the backbone kernel at zero): the image
     ids in the seeded shuffle's order, the results equal to
     ``predict_batch`` over the pixels as written (not through the data
     layer), more than one distinct caption, ``metric_eval`` with all seven
     metrics finite; the same ``evaluate`` on the fused backbone
     (``fused_ir_block`` at 17 × the batches, results equal to its
     ``predict_batch``), and both encodes' ``evaluate`` in float32 (equal
     captions: in bf16 they round apart); then the port's
     ``test.py`` (equal to ``evaluate_img``) and ``evaluate.py`` (equal
     results, the metric table printed) from the files. One line: images/s,
     seconds in ``predict_batch`` and on the host, seconds in
     ``metric_eval``, with the card's name and power limit.
 14. decode modes — the non-fused KV-cached step (plain PyTorch, no decode
     kernel) at full width. The checks of (a)-(c), (e) and (f) run on the
     evaluate phase's weights (``eval_variables``: peaked logits, so greedy
     choices stay clear of near ties), beam 8, float32 and bf16; (d) and
     (g) on the main path's. (a) the non-fused and the fused fast beam
     search in lock step, float32, batch 8 and 64: at every step the fused
     step's top candidates within 1e-3 of the non-fused totals at the same
     ids, its ids the non-fused ones wherever clear of a near tie (1e-3; the
     count printed, none fails); free running, float32 sequences equal on
     every item whose deciding candidate gaps stay above 1e-3 (the count
     printed: beam-8 gaps on these weights fall to ~1e-5), and bf16 through
     ``use_pallas=False``; (b) parity mode at batch 8, float32 and bf16:
     the three crafted ties of tests/test_decode.py exact, parity equal to
     greedy on items clear of a near tie; (c) ``sample_batch`` at batch 64,
     bf16: a seed twice gives the same captions, temperature 0 greedy's on
     clear items, mixed per-row temperature/top_p with ``top_k=5``; the five
     decode kernels' counters 0 across the non-fused runs of (a)-(c); (d)
     one sampling run on the fused backbone: ``fused_ir_block`` 17
     launches; (e) the server in ``decode="sample"`` (float32): four
     requests 200, ``top_p=0`` and ``temperature=nan`` 400, a
     temperature-0 request the greedy caption of its padded batch; (f)
     ``predict_with_attention`` (float32): the sequence ``predict_batch``'s,
     12 weight tensors of (1, 8, L, L) and (1, 8, L, 16) whose rows sum to 1
     within 1e-3, decode launches the steps × the per-step counts; the plot
     where matplotlib imports; (g) images/s of the non-fused and fused
     routes in turns at batch 8 and 64, parity at 8, ``sample_batch`` at 64
     with and without ``top_p`` (bf16).

Then the kernel table as one JSON line (every kernel: the decode step's, the
backbone's and the probes'; ``launches`` from the main path's runs,
``evaluate_launches`` from phase 13's, ``decode_modes_launches`` from phase
14's counted runs), the card's name and power limit, and
``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of bytes / memory rate and operations / the rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

B, BEAM, D, H, DFF, NL, LENC, V, MAX_LEN = 64, 8, 512, 8, 2048, 6, 16, 2000, 60
BK = B * BEAM
# (name, K, N, activation, float32 output) of each linear of the decode step
STEP_LINEARS = (("qkv", D, 3 * D, "none", False), ("out", D, D, "none", True),
                ("cross_q", D, D, "none", False), ("cross_out", D, D, "none", True),
                ("ffn1", D, DFF, "leaky_relu", False), ("ffn2", DFF, D, "none", True),
                ("vocab", D, V, "none", True))
TPU_KERNEL = "fpn_mt_image_captioning_tpu/ops/fused_decoder.py:164"
SOURCE = "fpn_mt_image_captioning_torch/csrc/fused_decoder.cu"
BACKBONE_TPU_KERNEL = "fpn_mt_image_captioning_tpu/ops/fused_backbone.py:140"
BACKBONE_SOURCE = "fpn_mt_image_captioning_torch/csrc/fused_backbone.cu"
PROBE_SOURCE = "fpn_mt_image_captioning_torch/csrc/probes.cu"
_STEP_TPU = "scripts/probe_launch_overhead.py:189"
_SLAB_D_TPU = "scripts/probe_grid_cell.py:188"
PROBE_TPU_KERNELS = {
    "add_one": "scripts/probe_launch_overhead.py:53; scripts/probe_pallas_overhead.py:36",
    "add_one_grid7": "scripts/probe_launch_overhead.py:80",
    "decoder_linear_trivial": _STEP_TPU, "decoder_add_layernorm_trivial": _STEP_TPU,
    "decoder_self_attention_trivial": _STEP_TPU, "decoder_cross_attention_trivial": _STEP_TPU,
    "decoder_logsoftmax_topk_trivial": _STEP_TPU,
    "slab_copy_4d": "scripts/probe_grid_cell.py:84", "slab_copy_3d": "scripts/probe_grid_cell.py:118",
    "slab_copy_lane128": "scripts/probe_grid_cell.py:154", "slab_copy_flat": _SLAB_D_TPU,
    "slab_copy_flat_loads": _SLAB_D_TPU, "slab_copy_flat_cp_async": _SLAB_D_TPU,
}
SIZE, N_BLOCKS, CLI_FILES, SERVER_REQUESTS, EVAL_IMAGES = 512, 17, 70, 8, 40
EVAL_BEAM, EVAL_ITEMS = 4, 16   # the evaluation defaults: beam_search_n, decode_batch
WIDE_H = 2    # heads of the wide-head checks: d 512 / 2 = head width 256
SELF_POSITIONS, CROSS_LENCS = (1, 8, 30, 59), (LENC, 64)   # where (c) and (d) are timed alone
SMALL_BK = 8 * BEAM   # the rows of a batch of 8, where (c) and (d) are timed too
# the attention kernels' isolated device ms (phase_kernels, bf16), beside
# their in-situ means per launch in the traced main path
ISOLATED: dict[str, float] = {}
ATTENTION_KERNELS = ("self_attention", "cross_attention")   # parts of the kernels' names


class SmokeFailure(RuntimeError):
    pass


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


TIMING = {"bench_calls": 0, "profiler_windows_retried": 0}
PROFILE_WINDOWS = 12


def bench(fn, iters: int = 50, reps: int = 5, kernels: bool = True) -> tuple[float, float]:
    """``(device_ms, wall_ms)`` of one call of ``fn``. Device time is the sum
    of its kernels' durations as the CUDA profiler records them over
    ``iters`` calls, after warm-up. A Python loop of small launches is bound
    by the host, so CUDA events around the loop time the host: their median
    over ``reps`` runs is the wall time per call.

    Every call of ``fn`` launches the same kernels, so a window whose kernel
    count is not a multiple of ``iters`` lost some (CUPTI has been seen to
    drop launches, cluster launches most) and is profiled again, up to
    PROFILE_WINDOWS times; then this raises with the counts it saw, so no
    wall time ever stands in for a device time. With ``kernels=False`` ``fn`` runs nothing on the card
    (it only allocates), and a window with no kernel gives 0.0."""
    import torch

    from fpn_mt_image_captioning_torch.utils.profiling import cuda_kernel_times

    TIMING["bench_calls"] += 1
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    wall = statistics.median(times)
    seen = []
    for attempt in range(PROFILE_WINDOWS):
        rows, _ = cuda_kernel_times(lambda: [fn() for _ in range(iters)])
        launches = sum(c for _, _, c in rows)
        if (launches or not kernels) and launches % iters == 0:
            return sum(us for _, us, _ in rows) / iters / 1e3, wall
        TIMING["profiler_windows_retried"] += 1
        seen.append(sorted((k[:60], c) for k, _, c in rows))
    raise SmokeFailure(f"the CUDA profiler lost launches in {PROFILE_WINDOWS} windows of {iters} calls: "
                       f"(kernel, launches) per window {seen}")


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def close(name: str, got, want, atol: float, rtol: float = 0.0) -> float:
    """Max |got - want|; raises on a non-finite value or any element over
    atol + rtol·|want|."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if not bool(got.isfinite().all()) or bool((err > atol + rtol * want.abs()).any()):
        raise SmokeFailure(f"{name}: max |err| {err.max().item():.3e} over the tolerance "
                           f"(atol {atol}, rtol {rtol})")
    return err.max().item()


def ids_agree(name: str, got_i, want_s, want_i, tol: float) -> int:
    """Ids must be equal wherever the plain version's score is further than
    ``tol`` from both neighbours (``want_*`` may hold one more column than
    ``got_i`` so the last one has a right neighbour). Returns the count
    compared."""
    import torch

    k = got_i.shape[1]
    s = want_s.float()
    gap_l = torch.cat([torch.full_like(s[:, :1], math.inf), s[:, :-1] - s[:, 1:]], 1)
    gap_r = torch.cat([s[:, :-1] - s[:, 1:], torch.full_like(s[:, :1], math.inf)], 1)
    clear = ((gap_l > tol) & (gap_r > tol))[:, :k]
    if want_s.shape[1] == k:   # no right neighbour for the last column
        clear[:, -1] &= False
    bad = clear & (got_i != want_i[:, :k])
    if bool(bad.any()):
        raise SmokeFailure(f"{name}: {int(bad.sum())} ids differ where the scores are clear")
    return int(clear.sum())


def self_attention_bound(torch, src_t, pos, bk, dt_name):
    """((ms, by), distinct rows) of (c) at ``pos`` over ``bk`` rows: q, k_t,
    v_t, the context and the two cache writes, and K and V of each distinct
    (position, physical row) the ancestry reaches, once each."""
    esz = 2 if dt_name == "bfloat16" else 4
    dev = src_t.device
    phys = (torch.arange(bk, device=dev) // BEAM) * BEAM + src_t[:pos, :bk].long()
    distinct = int(torch.unique(phys + bk * torch.arange(pos, device=dev)[:, None]).numel())
    nbytes = (bk * 3 * D + 2 * distinct * D + bk * D + 2 * bk * D) * esz + pos * bk * 4
    return bound(nbytes, 4 * bk * D * (pos + 1), dt_name), distinct


def cross_attention_bound(lenc, items, dt_name):
    """(ms, by) of (d) over ``items`` items' beams: q, the items' K/V and the
    context, once each."""
    esz = 2 if dt_name == "bfloat16" else 4
    bk = items * BEAM
    return bound((bk * D + lenc * items * 2 * D + bk * D) * esz, 4 * bk * D * lenc, dt_name)


def attention_small_batch(fd, torch, dev, g):
    """(c) at positions 8, 30 and 59 and (d) at Lenc 16 over the rows of a
    batch of 8 (bf16): each held to its plain version, timed, with its bound,
    and (d) beside SDPA."""
    bf16, bk, items, lpad, layer = torch.bfloat16, SMALL_BK, SMALL_BK // BEAM, 64, 2
    tol = dict(atol=1e-2, rtol=1e-2)
    rand = lambda *shape: torch.randn(*shape, generator=g).to(dev, bf16)
    qkv, caches = rand(bk, 3 * D), (rand(NL, lpad, bk, D), rand(NL, lpad, bk, D))
    src_t = torch.randint(0, BEAM, (lpad, bk), generator=g, dtype=torch.int32).to(dev)
    line = {}
    for pos in (8, 30, 59):
        entry = attention_case(
            fd, torch, f"decoder_self_attention[pos={pos},rows={bk}]", tol,
            lambda k, v: fd.decoder_self_attention(qkv, k, v, layer, pos, src_t, BEAM, H),
            lambda k, v: fd.decoder_self_attention_reference(qkv, k, v, layer, pos, src_t, BEAM, H),
            caches)
        (entry["bound_ms"], _), entry["distinct_rows"] = self_attention_bound(
            torch, src_t, pos, bk, "bfloat16")
        line[f"self_attention_pos{pos}_rows{bk}"] = entry
    q, kv_cross = rand(bk, D), rand(NL, LENC, items, 2 * D)
    entry = attention_case(fd, torch, f"decoder_cross_attention[Lenc={LENC},rows={bk}]", tol,
                           lambda: fd.decoder_cross_attention(q, kv_cross, layer, BEAM, H),
                           lambda: fd.decoder_cross_attention_reference(q, kv_cross, layer, BEAM, H))
    dh = D // H
    qs = q.reshape(items, BEAM, H, dh).transpose(1, 2)
    kx = kv_cross[layer, :, :, :D].reshape(LENC, items, H, dh).permute(1, 2, 0, 3).contiguous()
    vx = kv_cross[layer, :, :, D:].reshape(LENC, items, H, dh).permute(1, 2, 0, 3).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    close(f"decoder_cross_attention[rows={bk}] library check",
          sdpa(qs, kx, vx).transpose(1, 2).reshape(bk, D),
          fd.decoder_cross_attention_reference(q, kv_cross, layer, BEAM, H), atol=2e-2, rtol=2e-2)
    entry["library_ms"], entry["library_wall_ms"] = bench(lambda: sdpa(qs, kx, vx))
    entry["bound_ms"] = cross_attention_bound(LENC, items, "bfloat16")[0]
    line[f"cross_attention_lenc{LENC}_rows{bk}"] = entry
    return line


def attention_case(fd, torch, label, tol, kernel, plain, caches=()):
    """An attention kernel against its plain version on the same inputs
    (each on its own copy of ``caches``, whose writes must be bitwise equal),
    then both timed."""
    mine, theirs = [c.clone() for c in caches], [c.clone() for c in caches]
    err = close(label, kernel(*mine), plain(*theirs), **tol)
    if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
        raise SmokeFailure(f"{label}: cache writes differ")
    ms, wall = bench(lambda: kernel(*mine))
    plain_ms, plain_wall = bench(lambda: plain(*theirs))
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "wall_ms": wall,
            "plain_wall_ms": plain_wall}


# ---------------------------------------------------------------------------
def phase_kernels(fd, torch, dev):
    """Each kernel vs its plain version at the flagship shapes."""
    g = torch.Generator().manual_seed(1234)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    table, line = {}, {}
    lpad, layer = 64, 2
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        f32 = dt == torch.float32
        tol = dict(atol=3e-4) if f32 else dict(atol=1e-2, rtol=1e-2)
        esz = 4 if f32 else 2

        # (a) every linear shape of the step, at batch 64 (M = 512) and 8 (M = 64)
        for m in (BK, 8 * BEAM):
            for name, k, n, act, out_f32 in STEP_LINEARS + (
                    (("odd", 100, 36, "gelu", False),) if m == BK else ()):  # K, N not /8
                x = rand(m, k, dtype=dt)
                w = rand(k, n, scale=math.sqrt(2.0 / k), dtype=dt)
                b = rand(n, scale=0.1)
                got = fd.decoder_linear(x, w, b, act, out_f32)
                want = fd.decoder_linear_reference(x, w, b, act, out_f32)
                err = close(f"decoder_linear[{name},M={m},{dt_name}]", got, want, **tol)
                ms, wall = bench(lambda: fd.decoder_linear(x, w, b, act, out_f32))
                plain, plain_wall = bench(lambda: fd.decoder_linear_reference(x, w, b, act, out_f32))
                wt, bt = w.t().contiguous(), b.to(dt)
                lib, lib_wall = bench(lambda: torch.nn.functional.linear(x, wt, bt))
                nbytes = (m * k + k * n) * esz + m * n * (4 if out_f32 else esz) + n * 4
                bnd = bound(nbytes, 2 * m * k * n, dt_name)
                plan = (fd.linear_plan(m, n, k) if not f32 and k % 8 == 0 and n % 8 == 0
                        else None)
                line[f"linear_{name}_M{m}_{dt_name}"] = dict(
                    err=err, ms=ms, wall_ms=wall, plain_ms=plain, plain_wall_ms=plain_wall,
                    library_ms=lib, library_wall_ms=lib_wall, bound_ms=bnd[0],
                    plan=None if plan is None else plan._asdict())
                if name == "qkv" and m == BK and not f32:
                    table["decoder_linear"] = dict(
                        shape=f"qkv M={m} K={k} N={n} bf16 (library: F.linear; every step "
                              "shape at M=512 and 64 in the kernels line)",
                        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound=bnd)

        # (b) add + LayerNorm at batch 64 and 8, residual in the compute dtype
        # and in float32
        for rows in (BK, 8 * BEAM):
            for rname, r_dt in (("r_t", dt), ("r_f32", torch.float32)):
                y, r = rand(rows, D), rand(rows, D, dtype=r_dt)
                gamma, beta = 1 + rand(D, scale=0.1), rand(D, scale=0.1)
                got_f, got_t = fd.decoder_add_layernorm(y, r, gamma, beta, dt)
                want_f, want_t = fd.decoder_add_layernorm_reference(y, r, gamma, beta, dt)
                label = f"decoder_add_layernorm[{rname},rows={rows},{dt_name}]"
                err = max(close(f"{label} f32", got_f, want_f, atol=3e-4),
                          close(label, got_t, want_t, **tol))
                ms, wall = bench(lambda: fd.decoder_add_layernorm(y, r, gamma, beta, dt))
                plain, plain_wall = bench(
                    lambda: fd.decoder_add_layernorm_reference(y, r, gamma, beta, dt))
                v = y + r.float()
                lib, lib_wall = bench(
                    lambda: torch.nn.functional.layer_norm(v, (D,), gamma, beta, 1e-6))
                r_esz = 4 if r_dt == torch.float32 else esz
                nbytes = rows * D * (4 + r_esz + esz + (0 if f32 else 4)) + 2 * D * 4
                bnd = bound(nbytes, 8 * rows * D, "float32")
                line[f"layernorm_{rname}_rows{rows}_{dt_name}"] = dict(
                    err=err, ms=ms, wall_ms=wall, plain_ms=plain, plain_wall_ms=plain_wall,
                    library_ms=lib, library_wall_ms=lib_wall, bound_ms=bnd[0])
                if rname == "r_t" and rows == BK and not f32:
                    table["decoder_add_layernorm"] = dict(
                        shape=f"rows={rows} d={D} bf16 (library: layer_norm of y + r; rows "
                              "512 and 64 in the kernels line)",
                        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound=bnd)

        # (c) self-attention at positions 1, 8, 30 and 59 through a random ancestry,
        # each with its own bound; beside it, as a yardstick only, SDPA over
        # K/V gathered beforehand (two calls, not the rule's library call)
        qkv = rand(BK, 3 * D, dtype=dt)
        k_self, v_self = rand(NL, lpad, BK, D, dtype=dt), rand(NL, lpad, BK, D, dtype=dt)
        src_t = torch.randint(0, BEAM, (lpad, BK), generator=g, dtype=torch.int32).to(dev)
        for pos in SELF_POSITIONS:
            k1, v1, k2, v2 = k_self.clone(), v_self.clone(), k_self.clone(), v_self.clone()
            label = f"decoder_self_attention[pos={pos},{dt_name}]"
            got = fd.decoder_self_attention(qkv, k1, v1, layer, pos, src_t, BEAM, H)
            want = fd.decoder_self_attention_reference(qkv, k2, v2, layer, pos, src_t, BEAM, H)
            err = close(label, got, want, **tol)
            if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
                raise SmokeFailure(f"{label}: cache writes differ")
            ms, wall = bench(lambda: fd.decoder_self_attention(qkv, k1, v1, layer, pos, src_t, BEAM, H))
            plain, plain_wall = bench(lambda: fd.decoder_self_attention_reference(
                qkv, k2, v2, layer, pos, src_t, BEAM, H))
            entry = {"err": err, "ms": ms, "plain_ms": plain, "wall_ms": wall,
                     "plain_wall_ms": plain_wall}
            if not f32:
                bnd, distinct = self_attention_bound(torch, src_t, pos, BK, dt_name)
                phys = (torch.arange(BK, device=dev) // BEAM) * BEAM + src_t[:pos].long()
                p_idx = torch.arange(pos, device=dev)[:, None]
                heads = lambda t: t.reshape(pos + 1, BK, H, D // H).permute(1, 2, 0, 3).contiguous()
                kg = heads(torch.cat([k1[layer][p_idx, phys], qkv[None, :, D:2 * D]]))
                vg = heads(torch.cat([v1[layer][p_idx, phys], qkv[None, :, 2 * D:]]))
                qh = qkv[:, :D].reshape(BK, H, 1, D // H)
                sdpa = torch.nn.functional.scaled_dot_product_attention
                close(f"{label} yardstick check", sdpa(qh, kg, vg).reshape(BK, D), want,
                      atol=2e-2, rtol=2e-2)
                yard = bench(lambda: sdpa(qh, kg, vg))[0]
                entry.update(bound_ms=bnd[0], distinct_rows=distinct,
                             sdpa_pregathered_ms=yard,
                             sdpa_pregathered_note="two calls, not the rule's library call: "
                                                   "the gather is not timed")
                ISOLATED[f"decoder_self_attention_pos{pos}"] = ms
                if pos == 30:
                    table["decoder_self_attention"] = dict(
                        shape=f"BK={BK} d={D} H={H} pos={pos} bf16 (positions 1, 8, 30 and 59 "
                              "in the kernels line, each with its bound)",
                        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=None, bound=bnd)
            line[f"self_attention_pos{pos}_{dt_name}"] = entry
            del k1, v1, k2, v2
        # head width 256 (d 512, 2 heads): bf16 on the fast kernel's 32 lanes,
        # float32 on the wide kernel
        line[f"self_attention_dh{D // WIDE_H}_pos30_{dt_name}"] = attention_case(
            fd, torch, f"decoder_self_attention[dh={D // WIDE_H},pos=30,{dt_name}]", tol,
            lambda k, v: fd.decoder_self_attention(qkv, k, v, layer, 30, src_t, BEAM, WIDE_H),
            lambda k, v: fd.decoder_self_attention_reference(qkv, k, v, layer, 30, src_t, BEAM,
                                                             WIDE_H), (k_self, v_self))
        del k_self, v_self

        # (d) cross-attention over the per-item encoder K/V, Lenc 16 and 64
        q = rand(BK, D, dtype=dt)
        for lenc in CROSS_LENCS:
            kv_cross = rand(NL, lenc, B, 2 * D, dtype=dt)
            label = f"decoder_cross_attention[Lenc={lenc},{dt_name}]"
            got = fd.decoder_cross_attention(q, kv_cross, layer, BEAM, H)
            want = fd.decoder_cross_attention_reference(q, kv_cross, layer, BEAM, H)
            err = close(label, got, want, **tol)
            ms, wall = bench(lambda: fd.decoder_cross_attention(q, kv_cross, layer, BEAM, H))
            plain, plain_wall = bench(
                lambda: fd.decoder_cross_attention_reference(q, kv_cross, layer, BEAM, H))
            entry = {"err": err, "ms": ms, "plain_ms": plain, "wall_ms": wall,
                     "plain_wall_ms": plain_wall}
            if not f32:
                dh = D // H
                qs = q.reshape(B, BEAM, H, dh).transpose(1, 2)                     # (B, H, beam, dh)
                kx = kv_cross[layer, :, :, :D].reshape(lenc, B, H, dh).permute(1, 2, 0, 3)
                vx = kv_cross[layer, :, :, D:].reshape(lenc, B, H, dh).permute(1, 2, 0, 3)
                kx, vx = kx.contiguous(), vx.contiguous()
                sdpa = torch.nn.functional.scaled_dot_product_attention
                lib_out = sdpa(qs, kx, vx).transpose(1, 2).reshape(BK, D)
                close(f"{label} library check", lib_out, want, atol=2e-2, rtol=2e-2)
                lib, lib_wall = bench(lambda: sdpa(qs, kx, vx))
                bnd = cross_attention_bound(lenc, B, dt_name)
                entry.update(bound_ms=bnd[0], library_ms=lib, library_wall_ms=lib_wall)
                ISOLATED[f"decoder_cross_attention_lenc{lenc}"] = ms
                if lenc == LENC:
                    table["decoder_cross_attention"] = dict(
                        shape=f"BK={BK} B={B} Lenc={lenc} d={D} H={H} bf16, tensor-core kernel "
                              "(library: SDPA; Lenc 16 and 64 in the kernels line, float32 on "
                              "the CUDA-core kernel)",
                        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, bound=bnd)
            line[f"cross_attention_lenc{lenc}_{dt_name}"] = entry
            if lenc == LENC:   # head width 256: the wide kernel
                line[f"cross_attention_dh{D // WIDE_H}_lenc{lenc}_{dt_name}"] = attention_case(
                    fd, torch, f"decoder_cross_attention[dh={D // WIDE_H},Lenc={lenc},{dt_name}]",
                    tol, lambda: fd.decoder_cross_attention(q, kv_cross, layer, BEAM, WIDE_H),
                    lambda: fd.decoder_cross_attention_reference(q, kv_cross, layer, BEAM, WIDE_H))
            del kv_cross

    line.update(attention_small_batch(fd, torch, dev, g))

    # (e) log-softmax + freeze + top-k
    logits, scores, finished = topk_inputs(torch, dev)
    got_s, got_i = fd.decoder_logsoftmax_topk(logits, scores, finished, BEAM)
    want_s, want_i = fd.decoder_logsoftmax_topk_reference(logits, scores, finished, BEAM)
    err = close("decoder_logsoftmax_topk scores", got_s, want_s, atol=3e-4)
    if not torch.equal(got_i, want_i):
        raise SmokeFailure("decoder_logsoftmax_topk: ids differ")
    ms, wall = bench(lambda: fd.decoder_logsoftmax_topk(logits, scores, finished, BEAM))
    plain, plain_wall = bench(lambda: fd.decoder_logsoftmax_topk_reference(logits, scores, finished, BEAM))
    lib, lib_wall = bench(lambda: torch.topk(torch.log_softmax(logits, -1), BEAM, dim=-1))
    line["logsoftmax_topk"] = {"err": err, "ms": ms, "plain_ms": plain, "wall_ms": wall, "plain_wall_ms": plain_wall}
    table["decoder_logsoftmax_topk"] = dict(
        shape=f"BK={BK} V={V} topk={BEAM} f32 (library: log_softmax + topk)",
        max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
        bound=bound(BK * V * 4 + BK * 8 + BK * BEAM * 8, 6 * BK * V, "float32"))
    say("kernels", **line)
    return table


def topk_inputs(torch, dev, n_rows: int = BK):
    """(e)'s inputs over ``n_rows`` rows (the flagship's by default): float32
    logits spaced apart (no accidental near ties), exact ties planted on
    purpose, running scores and a quarter of the rows finished."""
    g = torch.Generator().manual_seed(4321)
    perm = torch.argsort(torch.rand(n_rows, V, generator=g), dim=1).float()
    logits = (perm / V * 8 - 4).to(dev)
    top = logits.argmax(1)
    rows = torch.arange(16, device=dev)
    logits[rows, V - 1 - rows] = logits[rows, top[:16]]          # exact duplicates
    scores = torch.randn(n_rows, 1, generator=g).to(dev)
    finished = (torch.rand(n_rows, 1, generator=g) < 0.25).float().to(dev)
    return logits, scores, finished


def kernel_turns(previous, present, rounds: int = 2) -> dict:
    """Device ms of ``previous`` and ``present`` in turns (previous, present,
    present, previous, ``rounds`` times), each through ``bench``."""
    runs = {"previous": [], "present": []}
    for _ in range(rounds):
        for name in ("previous", "present", "present", "previous"):
            runs[name].append(bench(previous if name == "previous" else present,
                                    iters=10, reps=2)[0])
    return {**runs, "previous_ms": statistics.median(runs["previous"]),
            "present_ms": statistics.median(runs["present"])}


def phase_previous_in_turns(fd, fb, torch, dev):
    """The two redesigned kernels against their previous designs
    (``ops/previous.py``) on the same inputs, in turns: (e) at 512×2000, top
    8, and ``fused_ir_block`` in bfloat16 at every distinct block shape of a
    flagship encode, summed over the 17 launches for each turn. Each previous
    kernel is held to the plain version as the present one is."""
    from fpn_mt_image_captioning_torch.ops import previous as pv

    logits, scores, finished = topk_inputs(torch, dev)
    want_s, want_i = fd.decoder_logsoftmax_topk_reference(logits, scores, finished, BEAM)
    prev_s, prev_i = pv.decoder_logsoftmax_topk_previous(logits, scores, finished, BEAM)
    close("decoder_logsoftmax_topk_previous scores", prev_s, want_s, atol=3e-4)
    if not torch.equal(prev_i, want_i):
        raise SmokeFailure("decoder_logsoftmax_topk_previous: ids differ")
    topk = kernel_turns(
        lambda: pv.decoder_logsoftmax_topk_previous(logits, scores, finished, BEAM),
        lambda: fd.decoder_logsoftmax_topk(logits, scores, finished, BEAM), rounds=3)

    net = perturbed_backbone(torch)
    packed = fb.packed_to(fb.pack_backbone_weights(net, torch.bfloat16), dev)
    shapes = block_shapes(packed)
    g = torch.Generator().manual_seed(31)
    per_block, turns = {}, [0.0] * 8
    for indices in distinct_blocks(shapes).values():
        sh = shapes[indices[0]]
        blk, meta = packed["blocks"][sh["index"]]
        x = torch.randn(B, sh["hw"], sh["hw"], sh["cin"], generator=g).to(dev, torch.bfloat16)
        kw = dict(stride=meta["stride"], residual=meta["residual"])
        close(f"fused_ir_block_previous[block {sh['index']}]",
              pv.fused_ir_block_previous(x, blk, **kw), fb.fused_ir_block_reference(x, blk, **kw),
              atol=1e-2, rtol=1e-2)
        t = kernel_turns(lambda: pv.fused_ir_block_previous(x, blk, **kw),
                         lambda: fb.fused_ir_block(x, blk, **kw))
        # the eight times in the order they were taken
        order = [v for four in zip(t["previous"][0::2], t["present"][0::2], t["present"][1::2],
                                   t["previous"][1::2]) for v in four]
        turns = [a + len(indices) * b for a, b in zip(turns, order)]
        per_block["_".join(map(str, indices))] = dict(previous_ms=t["previous_ms"],
                                                      present_ms=t["present_ms"])
        del x
    labels = ["previous", "present", "present", "previous"] * 2
    enc = {"previous": [v for n, v in zip(labels, turns) if n == "previous"],
           "present": [v for n, v in zip(labels, turns) if n == "present"]}
    say("previous_in_turns", order="previous, present, present, previous",
        logsoftmax_topk=topk, fused_ir_block_per_encode=enc,
        fused_ir_block_per_encode_median=dict(previous_ms=statistics.median(enc["previous"]),
                                              present_ms=statistics.median(enc["present"])),
        fused_ir_block_blocks=per_block)
    return topk["previous_ms"], statistics.median(enc["previous"])


def phase_linear_plans(fd, torch, dev):
    """The wgmma linear at every step shape (bf16, M = 512 and 64), and at
    K = 64 (one slice a CTA), under each tile height and K split it can take
    (at most 4 CTAs an SM): each held to the plain version, timed, beside
    the default plan's choice."""
    g = torch.Generator().manual_seed(77)
    line = {}
    for m in (BK, 8 * BEAM):
        # one K slice a CTA without a split: the kernel's fixed cost
        for name, k, n, act, out_f32 in STEP_LINEARS + (("one_slice", 64, D, "none", True),):
            if name in ("cross_q", "cross_out"):   # the shapes of out
                continue
            x = (torch.randn(m, k, generator=g)).to(dev, torch.bfloat16)
            w = (torch.randn(k, n, generator=g) * math.sqrt(2.0 / k)).to(dev, torch.bfloat16)
            b = (torch.randn(n, generator=g) * 0.1).to(dev)
            want = fd.decoder_linear_reference(x, w, b, act, out_f32)
            times = {}
            for bm in (64, 128):
                for split in (1, 2, 4, 8):
                    try:
                        plan = fd.linear_plan(m, n, k, bm=bm, split=split)
                    except ValueError:
                        continue
                    if plan.grid_n * plan.grid_m * split > 4 * 132:
                        continue
                    got = fd.decoder_linear(x, w, b, act, out_f32, plan=plan)
                    close(f"decoder_linear[{name},M={m},bm={bm},split={split}]", got, want,
                          atol=1e-2, rtol=1e-2)
                    times[f"bm{bm}_split{split}"] = bench(
                        lambda: fd.decoder_linear(x, w, b, act, out_f32, plan=plan),
                        reps=3)[0]
            chosen = fd.linear_plan(m, n, k)
            line[f"{name}_M{m}"] = dict(ms=times, chosen=f"bm{chosen.bm}_split{chosen.split}")
    say("linear_plans", **line)


def phase_whole_step(fd, torch, dev, pipe, dt_name, tag="", items=B, beam=BEAM, timed=True):
    """fused_decode_step vs fused_decode_step_reference, 8 synchronised steps
    over ``items`` items of ``beam`` beams (the line ``whole_step_<dtype><tag>``);
    with ``timed`` both are timed after."""
    bk = items * beam
    dt = getattr(torch, dt_name)
    tol = 3e-4 if dt_name == "float32" else 0.1
    model = pipe.transformer
    packed = fd.pack_decoder_weights(model, dt)
    g = torch.Generator().manual_seed(99)
    enc = torch.randn(items, LENC, D, generator=g).to(dev, dt)
    cache_k = fd.init_fused_cache(packed, enc, beam, MAX_LEN)
    cache_r = fd.init_fused_cache(packed, enc, beam, MAX_LEN)
    lpad = cache_k["k_self"].shape[1]
    own = (torch.arange(bk, device=dev) % beam).to(torch.int32)
    src_t = own[None].repeat(lpad, 1)
    emb = model.decoder.embedding.weight.to(dt)
    from fpn_mt_image_captioning_torch.models.positional import raw_positional_encoding

    pe = torch.as_tensor(raw_positional_encoding(MAX_LEN, D), device=dev).to(dt)
    tokens = torch.full((bk,), pipe.start_token, device=dev, dtype=torch.long)
    scores = torch.zeros(bk, 1, device=dev)
    finished = torch.zeros(bk, 1, device=dev)
    kw = dict(num_layers=model.num_layers, beam=beam, num_heads=model.num_heads,
              activation=model.activation)
    worst, compared = 0.0, 0
    for t in range(8):
        x = emb[tokens] + pe[t]
        ks, ki, cache_k = fd.fused_decode_step(packed, cache_k, x, src_t, t, scores, finished,
                                               topk=beam, **kw)
        rs, ri, cache_r = fd.fused_decode_step_reference(
            packed, cache_r, x, src_t, t, scores, finished, topk=beam + 1, **kw)
        worst = max(worst, close(f"whole step {dt_name}{tag} t={t}", ks, rs[:, :beam],
                                 atol=tol))
        compared += ids_agree(f"whole step {dt_name}{tag} t={t}", ki, rs, ri, tol)
        tokens, scores = ki[:, 0].long(), ks[:, :1].contiguous()
        if t == 3:   # beam reorder: every beam adopts beam 0's ancestry
            src_t = src_t[:, (torch.arange(bk, device=dev) // beam) * beam]
        if t == 5:   # a third of the rows finish
            finished = (torch.arange(bk, device=dev) % 3 == 0).float()[:, None]
        src_t[t + 1] = own
    cache_err = max(close(f"whole step {dt_name}{tag} {c}", cache_k[c], cache_r[c], atol=tol)
                    for c in ("k_self", "v_self"))
    line = dict(num_heads=model.num_heads, items=items, beam=beam, max_abs_err=worst,
                cache_err=cache_err, ids_compared=compared, ids_total=8 * bk * beam)
    if not timed:
        say(f"whole_step_{dt_name}{tag}", **line)
        return
    step = bench(lambda: fd.fused_decode_step(
        packed, cache_k, x, src_t, 8, scores, finished, topk=beam, **kw), iters=5, reps=3)
    plain = bench(lambda: fd.fused_decode_step_reference(
        packed, cache_r, x, src_t, 8, scores, finished, topk=beam, **kw), iters=5, reps=3)
    say(f"whole_step_{dt_name}{tag}", **line, pos=8, step_device_ms=step[0],
        step_wall_ms=step[1], plain_device_ms=plain[0], plain_wall_ms=plain[1])


def phase_wide_heads(fd, torch, dev, pipe):
    """``predict_batch`` of 8 images on a full-width pipeline with 2 heads
    (head width 256: self-attention on the fast kernel's 32 lanes,
    cross-attention on the wide kernel), counters reset just before and
    read just after: every decode kernel launched, steps × its launches a
    step."""
    import numpy as np

    images = np.random.default_rng(88).integers(0, 256, (8, SIZE, SIZE, 3), dtype=np.uint8)
    reset_all_counts()
    t0 = time.perf_counter()
    seqs, lengths = pipe.predict_batch(images)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = fd.decoder_logsoftmax_topk.launches
    check_decode_counts(fd, decode_per_step(fd), steps)
    if seqs.shape != (8, MAX_LEN) or not ((lengths >= 0) & (lengths <= MAX_LEN)).all() \
            or (seqs < 0).any() or (seqs >= V).any():
        raise SmokeFailure("wide heads: tokens or lengths out of range")
    say("wide_heads_main_path", batch=8, d_model=D, num_heads=pipe.transformer.num_heads,
        head_width=D // pipe.transformer.num_heads, wall_s=wall, decode_steps=steps,
        launches=read_all_counts(), caption0=pipe.to_caption(seqs[0], lengths[0])[:60])


def phase_small_input(torch, dev, Config, Pipeline, tokenizer):
    """A small float32 model: the card's route vs the CPU's plain route."""
    cfg = Config(image_input_size=256, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
                 num_heads=4, dff=64, beam_search_n=4, compute_dtype="float32")
    images = torch.randint(0, 256, (3, 256, 256, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(5)).numpy()
    gpu = Pipeline(tokenizer, 12, cfg, seed=3, device=dev).predict_batch(images)
    cpu = Pipeline(tokenizer, 12, cfg, seed=3, device="cpu").predict_batch(images)
    for a, b in zip(gpu, cpu):
        if not (a.shape == b.shape and (a == b).all()):
            raise SmokeFailure(f"small input: card {gpu} vs CPU {cpu}")
    say("small_input", sequences=gpu[0].tolist(), lengths=gpu[1].tolist())


def synthetic_tokenizer(Tokenizer, filters):
    """A tokenizer fitted on a seeded synthetic corpus with a vocabulary of
    2000 (pad + unk + <start> + <end> + 1996 words)."""
    import numpy as np

    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in rng.permutation(V - 4)]
    texts = ["<start> " + " ".join(words[i:i + 10]) + " <end>" for i in range(0, len(words), 10)]
    tok = Tokenizer(num_words=10000, oov_token="unk", filters=filters)
    tok.fit_on_texts(texts)
    tok.add_padding_token()
    if len(tok.index_word) != V:
        raise SmokeFailure(f"synthetic vocabulary has {len(tok.index_word)} entries, not {V}")
    return tok


def profile_run(torch, fn, means=()) -> dict:
    """One traced run of ``fn`` (after an untraced one in the same profiler
    window): wall time, the device's busy time (sum of
    kernel and copy durations; kernels of one stream do not overlap) and
    idle share, the device time by kernel name, largest first, and for each
    name part in ``means`` the launches and mean µs a launch of the kernels
    whose names hold it. A window that records nothing is run again, up to
    three times; then this raises."""
    from fpn_mt_image_captioning_torch.utils.profiling import cuda_kernel_times

    for _ in range(3):
        rows, wall_ms = cuda_kernel_times(fn)
        if rows:
            break
    else:
        raise SmokeFailure("the CUDA profiler recorded no device time in three windows")
    rows = sorted(((k, us / 1e3, c) for k, us, c in rows), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    out = dict(wall_ms=wall_ms, device_busy_ms=busy, device_idle_share=1 - busy / wall_ms,
               top=[{"kernel": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:12]])
    for part in means:
        ms = sum(r[1] for r in rows if part in r[0])
        n = sum(r[2] for r in rows if part in r[0])
        out.setdefault("in_situ", {})[part] = dict(launches=n, us_per_launch=1e3 * ms / n if n else None)
    return out


def phase_main(fd, torch, dev, pipe):
    """Pipeline.predict_batch at full width: 8 images, then 64."""
    import numpy as np

    rng = np.random.default_rng(2024)
    size = pipe.config.image_input_size
    out = {}
    reset_all_counts()
    for batch in (8, 64):
        images = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
        start = fd.decoder_logsoftmax_topk.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.predict_batch(images)                  # warm-up
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        walls, encodes = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            seqs, lengths = pipe.predict_batch(images)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        n_steps = (fd.decoder_logsoftmax_topk.launches - start) // 6
        for _ in range(5):
            t0 = time.perf_counter()
            pipe.encode(images)
            torch.cuda.synchronize()
            encodes.append(time.perf_counter() - t0)
        trace = profile_run(torch, lambda: pipe.predict_batch(images), means=ATTENTION_KERNELS)
        captions = [pipe.to_caption(seqs[i], lengths[i]) for i in range(batch)]
        if seqs.shape != (batch, MAX_LEN) or seqs.dtype != np.int32:
            raise SmokeFailure(f"batch {batch}: sequences {seqs.shape} {seqs.dtype}")
        if not ((lengths >= 0) & (lengths <= MAX_LEN)).all() or (seqs < 0).any() \
                or (seqs >= V).any():
            raise SmokeFailure(f"batch {batch}: tokens or lengths out of range")
        if not all(isinstance(c, str) for c in captions):
            raise SmokeFailure(f"batch {batch}: a caption is not a string")
        wall, enc = statistics.median(walls), statistics.median(encodes)
        out[batch] = dict(wall_s=wall, wall_s_runs=walls, warmup_s=warmup_s, encode_s=enc,
                          decode_s=wall - enc, decode_steps=n_steps, images_per_s=batch / wall,
                          caption0=captions[0][:60], trace=trace)
    steps = fd.decoder_logsoftmax_topk.launches
    counts = read_all_counts()
    check_decode_counts(fd, decode_per_step(fd), steps)
    if counts["fused_ir_block"] != 0:
        raise SmokeFailure("the eager encode launched the fused backbone kernel")
    traces = {b: out[b].pop("trace") for b in out}
    say("main_path", batch8=out[8], batch64=out[64], total_decode_steps=steps,
        launches=counts)
    for b, trace in traces.items():
        say(f"trace_batch{b}", **trace)
    # each attention kernel's mean a launch over a traced predict_batch of 64
    # (positions 0-59, the cache cold in L2) beside its isolated time (L2 warm)
    say("attention_in_situ", batch=64, in_situ=traces[64]["in_situ"],
        isolated_us={k: 1e3 * v for k, v in ISOLATED.items()})
    return counts, out[64]


def decode_per_step(fd) -> dict:
    return {fd.decoder_linear: 6 * NL + 1, fd.decoder_add_layernorm: 3 * NL,
            fd.decoder_self_attention: NL, fd.decoder_cross_attention: NL,
            fd.decoder_logsoftmax_topk: 1}


def check_decode_counts(fd, per_step, steps) -> None:
    for k, n in per_step.items():
        if k.launches == 0 or k.launches != steps * n:
            raise SmokeFailure(f"{k.__name__}: {k.launches} launches for {steps} steps "
                               f"× {n} per step")


def all_kernels():
    from fpn_mt_image_captioning_torch.ops import fused_backbone, fused_decoder, probes

    return fused_decoder.KERNELS + fused_backbone.KERNELS + probes.KERNELS


def reset_all_counts() -> None:
    from fpn_mt_image_captioning_torch.ops import fused_backbone, fused_decoder, probes

    fused_decoder.reset_launch_counts()
    fused_backbone.reset_launch_counts()
    probes.reset_launch_counts()


def read_all_counts() -> dict:
    return {k.__name__: k.launches for k in all_kernels()}


# ---------------------------------------------------------------------------
# the fused backbone
# ---------------------------------------------------------------------------
def perturbed_backbone(torch, alpha: float = 1.0):
    """A float32 MobileNetV2 on the CPU: seeded init, BatchNorm statistics,
    scales and biases moved off their init (so the folding matters)."""
    from fpn_mt_image_captioning_torch.models.backbones.mobilenet_v2 import (
        BatchNorm32, MobileNetV2Backbone)
    from fpn_mt_image_captioning_torch.weights import init_weights

    net = MobileNetV2Backbone(alpha)
    init_weights(net, torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm32):
                m.running_mean += 0.1 * torch.randn(m.running_mean.shape, generator=g)
                m.running_var *= 0.5 + torch.rand(m.running_var.shape, generator=g)
                m.weight += 0.1 * torch.randn(m.weight.shape, generator=g)
                m.bias += 0.1 * torch.randn(m.bias.shape, generator=g)
    return net.eval()


def block_shapes(packed) -> list[dict]:
    """The 17 blocks of one flagship encode (512², batch 64): index, input
    extent, channels, stride, residual."""
    out, hw = [], SIZE // 2
    for i, (blk, meta) in enumerate(packed["blocks"]):
        cexp, cout = blk["w_proj"].shape
        cin = blk["w_exp"].shape[0] if "w_exp" in blk else cexp
        out.append(dict(index=i, hw=hw, cin=cin, cexp=cexp, cout=cout, stride=meta["stride"],
                        residual=meta["residual"], expand="w_exp" in blk))
        hw //= meta["stride"]
    return out


def distinct_blocks(shapes) -> dict:
    """Indices of the blocks of each distinct shape: a shape that repeats is
    timed once and counted n times."""
    distinct = {}
    for sh in shapes:
        key = (sh["hw"], sh["cin"], sh["cexp"], sh["cout"], sh["stride"], sh["residual"])
        distinct.setdefault(key, []).append(sh["index"])
    return distinct


def block_bound_parts(sh: dict, esz: int, dt_name: str) -> tuple[float, float]:
    """(bytes ms, operations ms) of one block: the input, the weights and the
    output moved once each; expand over the input pixels, depthwise and
    project over the output's."""
    hw, ho = sh["hw"], sh["hw"] // sh["stride"]
    cin, cexp, cout = sh["cin"], sh["cexp"], sh["cout"]
    pix_in, pix_out = B * hw * hw, B * ho * ho
    w_elems = (cin * cexp if sh["expand"] else 0) + cexp * cout
    f32_elems = (cexp if sh["expand"] else 0) + 10 * cexp + cout
    nbytes = (pix_in * cin + pix_out * cout + w_elems) * esz + f32_elems * 4
    flops = 2 * ((pix_in * cin * cexp if sh["expand"] else 0) + 9 * pix_out * cexp
                 + pix_out * cexp * cout)
    return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flops / PEAK_FLOPS[dt_name]


def phase_backbone_kernels(fb, torch, dev):
    """fused_ir_block vs its plain version at every distinct block shape of
    the flagship encode, float32 and bfloat16, timed beside the eager block."""
    from fpn_mt_image_captioning_torch.decode.beam_search import cast_for_inference

    net = perturbed_backbone(torch)
    shapes = block_shapes(fb.pack_backbone_weights(net, torch.float32))
    distinct = distinct_blocks(shapes)
    g = torch.Generator().manual_seed(31)
    rows, totals = {}, {}
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        f32 = dt == torch.float32
        tol = dict(atol=2e-4, rtol=1e-3) if f32 else dict(atol=1e-2, rtol=1e-2)
        packed = fb.packed_to(fb.pack_backbone_weights(net, dt), dev)
        tot = dict(ms=0.0, plain_ms=0.0, eager_ms=0.0, channels_last_ms=0.0, bound_ms=0.0,
                   bytes_bound_ms=0.0, bytes_bound_blocks_ms=0.0, max_abs_err=0.0)
        for indices in distinct.values():
            sh = shapes[indices[0]]
            blk, meta = packed["blocks"][sh["index"]]
            x = torch.randn(B, sh["hw"], sh["hw"], sh["cin"], generator=g).to(dev, dt)
            kw = dict(stride=meta["stride"], residual=meta["residual"])
            got = fb.fused_ir_block(x, blk, **kw)
            torch.cuda.synchronize()
            want = fb.fused_ir_block_reference(x, blk, **kw)
            err = close(f"fused_ir_block[block {sh['index']},{dt_name}]", got, want, **tol)
            del got, want
            ms, _ = bench(lambda: fb.fused_ir_block(x, blk, **kw), iters=5, reps=2)
            plain, _ = bench(lambda: fb.fused_ir_block_reference(x, blk, **kw), iters=3, reps=1)
            eager_block = cast_for_inference(
                copy.deepcopy(getattr(net, net._blocks[sh["index"]][0])), dt).to(dev)
            xc = x.permute(0, 3, 1, 2).contiguous()
            # the same cuDNN block on channels_last tensors: NHWC as the kernel
            # reads it, cuDNN's own fastest layout for these convolutions
            xl = xc.to(memory_format=torch.channels_last)
            with torch.no_grad():
                eager, _ = bench(lambda: eager_block(xc), iters=5, reps=2)
                ref = eager_block(xc).float()
                eager_block = eager_block.to(memory_format=torch.channels_last)
                rel = ((eager_block(xl).float() - ref).norm() / ref.norm()).item()
                if rel > 2e-2:   # the same block, another layout: the same function
                    raise SmokeFailure(f"channels_last block {sh['index']},{dt_name}: "
                                       f"relative L2 {rel:.3e} from the contiguous block")
                chain, _ = bench(lambda: eager_block(xl), iters=5, reps=2)
                del ref
            del eager_block, xc, xl, x
            pixels = B * (sh["hw"] // sh["stride"]) ** 2
            occupancy = fb.block_occupancy(sh["cin"], sh["cout"], sh["stride"], dt, sh["expand"],
                                           pixels)
            if not f32 and occupancy < 2:
                raise SmokeFailure(f"fused_ir_block block {sh['index']}: {occupancy} block an SM")
            t_bytes, t_ops = block_bound_parts(sh, 4 if f32 else 2, dt_name)
            n = len(indices)
            for k, v in (("ms", ms), ("plain_ms", plain), ("eager_ms", eager),
                         ("channels_last_ms", chain), ("bound_ms", max(t_bytes, t_ops))):
                tot[k] += n * v
            tot["bytes_bound_ms"] += n * t_bytes
            if t_bytes >= t_ops:
                tot["bytes_bound_blocks_ms"] += n * t_bytes
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            rows[f"{dt_name}_blocks_{'_'.join(map(str, indices))}"] = dict(
                shape=f"{sh['hw']}² {sh['cin']}→{sh['cexp']}→{sh['cout']} s{sh['stride']}"
                      f"{' +res' if sh['residual'] else ''}",
                max_abs_err=err, ms=ms, plain_ms=plain, eager_ms=eager, channels_last_ms=chain,
                blocks_per_sm=occupancy, plan=fb.tile_plan(
                    sh["cin"], sh["cout"], sh["stride"], dt, sh["expand"], pixels)._asdict(),
                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_bound_ms=t_bytes)
        totals[dt_name] = tot
    say("backbone_kernels", batch=B, size=SIZE, blocks=rows, per_encode=totals)
    bf = totals["bfloat16"]
    return dict(shape=f"the 17 blocks of one encode, batch {B}, {SIZE}², bf16 (sums over the "
                      "17 launches; per-block rows in the backbone_kernels line)",
                max_abs_err=bf["max_abs_err"], ms=bf["ms"], plain_ms=bf["plain_ms"],
                eager_ms=bf["eager_ms"], channels_last_ms=bf["channels_last_ms"], library_ms=None,
                bound=(bf["bound_ms"], "bytes" if bf["bytes_bound_blocks_ms"] >= 0.5 * bf["bound_ms"]
                       else "operations"))


def phase_backbone_whole(fb, torch, dev):
    """The fused backbone vs the plain fused backbone on the card. float32:
    every element within the bars. bfloat16: roundings that the summation
    order flips cascade through 17 blocks, so the kernel is held to stray
    from the float32 result no further than the plain version in bfloat16
    does (relative L2, 25 % margin + 1e-3)."""
    net = perturbed_backbone(torch)
    g = torch.Generator().manual_seed(41)
    images = (torch.rand(8, SIZE, SIZE, 3, generator=g) * 2 - 1).to(dev)
    run = lambda dt, plain: fb.fused_mobilenet_backbone(
        fb.packed_to(fb.pack_backbone_weights(net, dt), dev), images, plain=plain)
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    got32 = run(torch.float32, False)
    torch.cuda.synchronize()
    want32 = run(torch.float32, True)
    got16, want16 = run(torch.bfloat16, False), run(torch.bfloat16, True)
    line = {}
    for i, name in enumerate(("C3", "C4", "C5")):
        err32 = close(f"fused backbone {name} float32", got32[i], want32[i],
                      atol=2e-3 if name == "C5" else 2e-4, rtol=1e-3)
        r = dict(float32_max_abs_err=err32, bf16_kernel_vs_plain=rel(got16[i], want16[i]),
                 bf16_kernel_vs_f32=rel(got16[i], want32[i]),
                 bf16_plain_vs_f32=rel(want16[i], want32[i]))
        line[name] = r
        if not (bool(got16[i].isfinite().all())
                and r["bf16_kernel_vs_f32"] <= 1.25 * r["bf16_plain_vs_f32"] + 1e-3):
            raise SmokeFailure(f"fused backbone {name} bfloat16: {r}")
    say("backbone_whole", images=8, size=SIZE, shapes=[list(t.shape) for t in got16],
        note="bf16 columns: relative L2 errors", **line)


# ---------------------------------------------------------------------------
# the measurement probes
# ---------------------------------------------------------------------------
def phase_probes(torch, dev):
    """The three probe entry points as a user runs them (counters reset just
    before, read just after; every wrapper's count equal to what the probes'
    loops launch), then each probe kernel against its plain version at the
    probes' shapes."""
    from fpn_mt_image_captioning_torch.ops import probes as pr
    from fpn_mt_image_captioning_torch.scripts import (probe_grid_cell, probe_launch_overhead,
                                                       probe_pallas_overhead)

    scripts = (probe_launch_overhead, probe_pallas_overhead, probe_grid_cell)
    reset_all_counts()
    results = [m.measure(dev) for m in scripts]
    launch, chains, grid = results
    expected = {}
    for m, r in zip(scripts, results):
        for k, n in m.expected_launches(r).items():
            expected[k] = expected.get(k, 0) + n
    wrong = {k.__name__: (k.launches, expected.get(k, 0)) for k in all_kernels()
             if k.launches != expected.get(k, 0)}
    if wrong or not all(k.launches for k in pr.KERNELS):
        raise SmokeFailure(f"probe launch counts (counted, expected): {wrong}")
    counts = {k.__name__: k.launches for k in pr.KERNELS}
    say("probe_launch_overhead", **launch)
    slopes = {}
    for v in ("C decoder-shaped", "D compute-overlap", "E no-oh"):
        eager, graph = launch[v], launch[f"{v} graph"]
        slopes[v] = dict(
            launches_per_step=eager["launches_per_link"],
            eager_host_us_per_step=eager["host_us_per_link"],
            graph_host_us_per_step=graph["host_us_per_link"],
            graph_saves_host_us_per_step=eager["host_us_per_link"] - graph["host_us_per_link"],
            eager_device_us_per_step=eager.get("device_us_per_link"),
            graph_device_us_per_step=graph.get("device_us_per_link"))
    say("probe_slopes", **slopes)
    say("probe_pallas_overhead", **chains)
    say("probe_grid_cell", **grid)

    g = torch.Generator(dev).manual_seed(4321)
    table, line = {}, {}
    x = torch.randn(256, 256, generator=g, device=dev)
    for k in (pr.add_one, pr.add_one_grid7):
        if not torch.equal(k(x), pr.add_one_reference(x)):
            raise SmokeFailure(f"{k.__name__}: differs from x + 1")
        ms, wall = bench(lambda: k(x))
        plain, _ = bench(lambda: pr.add_one_reference(x))
        lib, _ = bench(lambda: torch.add(x, 1.0))
        table[k.__name__] = dict(shape="(256, 256) float32", max_abs_err=0.0, ms=ms,
                                 plain_ms=plain, library_ms=lib,
                                 bound=bound(2 * x.numel() * 4, x.numel(), "float32"))
        line[k.__name__] = dict(ms=ms, wall_ms=wall, plain_ms=plain, library_ms=lib)

    # the decode step on the trivial build: its result must be the contract;
    # each kind alone at the step's shapes (the empty bodies write nothing, so
    # their plain versions only allocate what the wrapper allocates)
    plo, td = probe_launch_overhead, pr.TRIVIAL_DECODER
    s = plo.step_setup(dev)
    s["scores"].normal_(generator=g)
    bk, d, beam, bf16 = plo.B_ITEMS * plo.BEAM, plo.D, plo.BEAM, torch.bfloat16
    want = pr.probe_step_reference(s["scores"], beam)
    if not torch.equal(pr.probe_step(s), want):
        raise SmokeFailure("probe_step: top-k scores differ from the running scores")
    p, xs, y32 = s["packed"]["layers"][0], s["x"], torch.zeros(bk, d, device=dev)
    cache, logits = s["cache"], torch.zeros(bk, plo.V, device=dev)
    qkv = torch.zeros(bk, 3 * d, dtype=bf16, device=dev)
    empty = lambda *shape, dt=bf16: (lambda: torch.empty(shape, dtype=dt, device=dev))
    kinds = {
        td.decoder_linear: ((xs, p["wqkv"], p["bqkv"]), empty(bk, 3 * d),
                            f"QKV, M={bk} K={d} N={3 * d}"),
        td.decoder_add_layernorm: ((y32, xs, *p["ln"][:2], bf16), empty(bk, d),
                                   f"rows={bk} d={d}"),
        td.decoder_self_attention: ((qkv, cache["k_self"], cache["v_self"], 0, 0, s["src_t"],
                                     beam, plo.H), empty(bk, d), f"BK={bk} H={plo.H} pos=0"),
        td.decoder_cross_attention: ((xs, cache["kv_cross"], 0, beam, plo.H), empty(bk, d),
                                     f"BK={bk} Lenc={plo.LENC}"),
        td.decoder_logsoftmax_topk: ((logits, s["scores"], s["finished"], beam),
                                     lambda: pr.probe_step_reference(s["scores"], beam),
                                     f"BK={bk} V={plo.V} topk={beam}"),
    }
    for k, (a, plain_fn, shape) in kinds.items():
        lib, nbytes = None, 0
        if k is td.decoder_logsoftmax_topk:
            if not torch.equal(k(*a)[0], want):
                raise SmokeFailure(f"{k.__name__}: differs from the running scores")
            sc = s["scores"]
            lib, _ = bench(lambda: sc.expand(-1, beam).contiguous())
            nbytes = bk * 4 + bk * beam * 4
        ms, wall = bench(lambda: k(*a))
        plain, _ = bench(plain_fn, kernels=k is td.decoder_logsoftmax_topk)
        body = ("float32, writes each row's running score (library: expand of the scores)"
                if lib is not None else "bf16, empty body, held through the step's result")
        table[k.__name__] = dict(
            shape=f"{shape}, {body}; fused_decoder.cu built with -DFD_TRIVIAL_BODIES",
            max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=lib,
            bound=bound(nbytes, 0, "float32"))
        line[k.__name__] = dict(ms=ms, wall_ms=wall, plain_ms=plain, library_ms=lib)

    pgc = probe_grid_cell
    b, hp, wp, c, rows, tiles = pgc.B, pgc.HP, pgc.WP, pgc.C, pgc.ROWS, pgc.N_TILES
    xg = torch.randn(b, hp, wp, c, generator=g, device=dev).to(bf16)
    for k, layout in ((pr.slab_copy_4d, "A"), (pr.slab_copy_3d, "B"), (pr.slab_copy_lane128, "C"),
                      (pr.slab_copy_flat, "D"), (pr.slab_copy_flat_loads, "D"),
                      (pr.slab_copy_flat_cp_async, "D")):
        got, want = k(xg, rows, tiles), pr.slab_copy_reference(xg, layout, rows, tiles)
        if got.shape != want.shape or not torch.equal(pr.slab_rows(got, xg.shape, rows, tiles),
                                                      pr.slab_rows(want, xg.shape, rows, tiles)):
            raise SmokeFailure(f"{k.__name__}: differs from 2·x on the slab rows")
        del got, want
        ms, wall = bench(lambda: k(xg, rows, tiles), iters=10, reps=3)
        plain, _ = bench(lambda: pr.slab_copy_reference(xg, layout, rows, tiles), iters=10, reps=3)
        lib = None if layout == "C" else bench(
            lambda: xg[:, 1:1 + rows * tiles].mul(2), iters=10, reps=3)[0]
        c_out = pr.LANES if layout == "C" else c
        nbytes = b * rows * tiles * wp * (c + c_out) * 2
        table[k.__name__] = dict(
            shape=f"x ({b}, {hp}, {wp}, {c}) bf16, {tiles} slabs of {rows} rows an item, "
                  f"layout {layout}" + (" (library: mul of the rows)" if lib is not None else ""),
            max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=lib,
            bound=bound(nbytes, b * rows * tiles * wp * c_out, "bfloat16"))
        line[k.__name__] = dict(ms=ms, wall_ms=wall, plain_ms=plain, library_ms=lib,
                                gb_per_s=nbytes / ms / 1e6)
    say("probe_kernels", **line)
    return table, counts


def perturbed(variables: dict) -> dict:
    """The JAX-layout ``variables`` with BatchNorm statistics and biases moved
    off their init (0/1 and 0), seeded: in place, returned."""
    import numpy as np

    rng = np.random.default_rng(7)

    def walk(tree, stats):
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, stats)
            elif stats and name == "mean":
                leaf += 0.1 * rng.standard_normal(leaf.shape, np.float32)
            elif stats and name == "var":
                leaf *= 0.5 + rng.random(leaf.shape, np.float32)
            elif not stats and name in ("bias", "bq", "bo", "kv_bias"):
                leaf += 0.1 * rng.standard_normal(leaf.shape, np.float32)

    walk(variables["params"], False)
    walk(variables["batch_stats"], True)
    return variables


def make_pipeline(torch, dev, fd, fb, Config, Pipeline, tokenizer, **cfg_kw):
    """The flagship pipeline with seeded weights whose BatchNorm statistics
    and biases are perturbed (they init to 0/1), decoder (and fused backbone)
    weights packed again after the perturbation, which is made on the card's
    copy after the cast."""
    from fpn_mt_image_captioning_torch.models.backbones.mobilenet_v2 import BatchNorm32

    cfg = Config(**{"beam_search_n": BEAM, "compute_dtype": "bfloat16", "decode_batch": B,
                    **cfg_kw})
    pipe = Pipeline(tokenizer, MAX_LEN, cfg, seed=0, device=dev)
    with torch.no_grad():
        g = torch.Generator().manual_seed(7)
        for m in pipe.transformer.modules():
            if isinstance(m, BatchNorm32):
                m.running_mean += 0.1 * torch.randn(m.running_mean.shape, generator=g).to(dev)
                m.running_var *= (0.5 + torch.rand(m.running_var.shape, generator=g)).to(dev)
        for name, p in pipe.transformer.named_parameters():
            if name.rsplit(".", 1)[-1] in ("bias", "bq", "bo", "kv_bias"):
                p += (0.1 * torch.randn(p.shape, generator=g)).to(dev, p.dtype)
        pipe.packed = fd.pack_decoder_weights(pipe.transformer, pipe.dtype)
        if pipe.backbone_packed is not None:   # folded from the bf16 weights here
            pipe.backbone_packed = fb.packed_to(fb.pack_backbone_weights(
                pipe.transformer.encoder.feature_extractor.backbone, pipe.dtype), dev)
    return pipe


def phase_fused_main(fd, fb, torch, pipe, eager, eager_out):
    """predict_batch at batch 64 with the fused backbone; counters reset just
    before and read just after. Then the fused encode against the eager one
    (``eager``, the same weights) in turns — eager, fused, fused, eager, five
    times — one traced encode of each, and both routes' ``predict_batch`` in
    turns."""
    import numpy as np

    images = np.random.default_rng(2024).integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)
    reset_all_counts()
    encodes = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.predict_batch(images)                      # warm-up
    torch.cuda.synchronize()
    warmup_s, encodes = time.perf_counter() - t0, encodes + 1
    start = fd.decoder_logsoftmax_topk.launches
    walls, encs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        seqs, lengths = pipe.predict_batch(images)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        encodes += 1
    n_steps = (fd.decoder_logsoftmax_topk.launches - start) // 5
    for _ in range(5):
        t0 = time.perf_counter()
        pipe.encode(images)
        torch.cuda.synchronize()
        encs.append(time.perf_counter() - t0)
        encodes += 1
    traced = []   # profile_run calls it twice a window (its warm-up step)
    trace = profile_run(torch, lambda: traced.append(pipe.predict_batch(images)))
    encodes += len(traced)
    counts = read_all_counts()
    check_decode_counts(fd, decode_per_step(fd), fd.decoder_logsoftmax_topk.launches)
    if counts["fused_ir_block"] == 0 or counts["fused_ir_block"] != N_BLOCKS * encodes:
        raise SmokeFailure(f"fused_ir_block: {counts['fused_ir_block']} launches for "
                           f"{encodes} encodes × {N_BLOCKS}")
    if seqs.shape != (B, MAX_LEN) or not ((lengths >= 0) & (lengths <= MAX_LEN)).all() \
            or (seqs < 0).any() or (seqs >= V).any():
        raise SmokeFailure("fused main path: tokens or lengths out of range")
    wall, enc = statistics.median(walls), statistics.median(encs)
    say("fused_main_path", batch=B, wall_s=wall, wall_s_runs=walls, warmup_s=warmup_s,
        encode_s=enc, encode_s_runs=encs, decode_s=wall - enc, decode_steps=n_steps,
        images_per_s=B / wall, eager_wall_s=eager_out["wall_s"],
        eager_encode_s=eager_out["encode_s"], encodes=encodes, launches=counts,
        caption0=pipe.to_caption(seqs[0], lengths[0])[:60])
    say("trace_fused_batch64", **trace)

    def in_turns(call):
        """Seconds of ``call(p)`` for each route, in turns: eager, fused,
        fused, eager, five times."""
        turns = {"eager": [], "fused": []}
        for _ in range(5):
            for name, p in (("eager", eager), ("fused", pipe), ("fused", pipe), ("eager", eager)):
                t0 = time.perf_counter()
                call(p)
                torch.cuda.synchronize()
                turns[name].append(time.perf_counter() - t0)
        return turns

    turns = in_turns(lambda p: p.encode(images))
    say("encode_compare", batch=B, eager_encode_s=statistics.median(turns["eager"]),
        fused_encode_s=statistics.median(turns["fused"]), runs=turns,
        trace_eager=profile_run(torch, lambda: eager.encode(images)),
        trace_fused=profile_run(torch, lambda: pipe.encode(images)))
    turns = in_turns(lambda p: p.predict_batch(images))
    say("predict_compare", batch=B, eager_wall_s=statistics.median(turns["eager"]),
        fused_wall_s=statistics.median(turns["fused"]), runs=turns)
    return counts


def png_bytes(arr) -> bytes:
    """An 8-bit RGB PNG of (H, W, 3) uint8 ``arr``, written with zlib."""
    h, w, _ = arr.shape
    import numpy as np

    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], 1).tobytes()

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def phase_cli(fd, torch, pipe, workdir):
    """caption.main over a directory of PNGs vs predict_batch on the pixels."""
    import numpy as np

    from fpn_mt_image_captioning_torch import caption

    rng = np.random.default_rng(77)
    pixels = rng.integers(0, 256, (CLI_FILES, SIZE, SIZE, 3), dtype=np.uint8)
    img_dir = Path(workdir) / "images"
    img_dir.mkdir()
    for i, a in enumerate(pixels):
        (img_dir / f"img{i:03d}.png").write_bytes(png_bytes(a))
    out_path = Path(workdir) / "captions.json"
    reset_all_counts()
    t0 = time.perf_counter()
    results = caption.main(pipe.config, str(img_dir), str(out_path), pipeline=pipe)
    cli_s = time.perf_counter() - t0
    counts = read_all_counts()
    written = json.loads(out_path.read_text())
    seqs, lengths = pipe.predict_batch(pixels)
    want = [pipe.to_caption(seqs[i], lengths[i]) for i in range(CLI_FILES)]
    got = [r["caption"] for r in written]
    if written != results or [Path(r["file"]).name for r in written] != \
            [f"img{i:03d}.png" for i in range(CLI_FILES)]:
        raise SmokeFailure("CLI: the JSON file differs from the results or misses files")
    if got != want:
        bad = sum(a != b for a, b in zip(got, want))
        raise SmokeFailure(f"CLI: {bad} of {CLI_FILES} captions differ from predict_batch")
    encodes = -(-CLI_FILES // pipe.config.decode_batch)
    if counts["fused_ir_block"] != N_BLOCKS * encodes:
        raise SmokeFailure(f"CLI: {counts['fused_ir_block']} backbone launches for "
                           f"{encodes} batches")
    say("cli", files=CLI_FILES, decode_batch=pipe.config.decode_batch, seconds=cli_s,
        launches=counts, equal_to_predict_batch=True, caption0=got[0][:60])
    return {Path(r["file"]).name: r["caption"] for r in written}, img_dir


def phase_server(torch, pipe, offline, img_dir):
    """The server on port 0 in a thread; 8 concurrent POSTs of the PNGs."""
    from fpn_mt_image_captioning_torch import serve

    srv = serve.make_server(pipe.config, port=0, serve_batch=B, max_delay_ms=500.0,
                            pipeline=pipe)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        if not (health["status"] == "ok" and health["fused_backbone"]
                and health["backend"] == str(pipe.device)):
            raise SmokeFailure(f"server: /healthz {health}")
        names = [f"img{i:03d}.png" for i in range(SERVER_REQUESTS)]

        def post(name):
            req = urllib.request.Request(base + "/caption", method="POST",
                                         data=(img_dir / name).read_bytes())
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read())

        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVER_REQUESTS) as pool:
            replies = list(pool.map(post, names))
        burst_s = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.close()
        thread.join(timeout=60)
    for name, (status, body) in zip(names, replies):
        if status != 200 or body["caption"] != offline[name]:
            raise SmokeFailure(f"server: {name} answered {status} {body!r}, offline "
                               f"{offline[name]!r}")
    say("server", requests=SERVER_REQUESTS, all_200=True, equal_to_offline=True,
        burst_s=burst_s, batches=stats["batches"], mean_batch_fill=stats["mean_batch_fill"],
        device_batch_ms=stats["device_batch_ms"], latency_ms=[b["latency_ms"] for _, b in replies])


def write_val_split(root: Path, tokenizer, n: int) -> tuple[str, dict]:
    """A synthetic COCO split ``val2017`` under ``root``: ``n`` seeded 512²
    PNGs, one caption each from the tokenizer's words. Each image is a dim
    noise floor over a colour of its own with a bright band at a place of its
    own, so the encoder tells them apart (uniform noise looks alike to it).
    Returns ``root`` and the pixels by image id."""
    import numpy as np

    rng = np.random.default_rng(31)
    words = [w for w in tokenizer.index_word.values() if w.startswith("w")]
    img_dir = root / "images" / "val2017"
    img_dir.mkdir(parents=True)
    (root / "annotations").mkdir()
    images, anns, pixels = [], [], {}
    for i in range(n):
        img_id = 9000 + i
        a = rng.integers(0, 60, (SIZE, SIZE, 3)) + rng.integers(0, 120, 3)
        lo = rng.integers(0, SIZE - SIZE // 8)
        a[lo:lo + SIZE // 8] = 255
        pixels[img_id] = a.astype(np.uint8)
        (img_dir / f"{img_id}.png").write_bytes(png_bytes(pixels[img_id]))
        images.append({"id": img_id, "file_name": f"{img_id}.png"})
        anns.append({"id": i + 1, "image_id": img_id,
                     "caption": " ".join(rng.choice(words, rng.integers(5, 13)))})
    (root / "annotations" / "captions_val2017.json").write_text(
        json.dumps({"images": images, "annotations": anns}))
    return str(root), pixels


def eval_variables(Config, Pipeline, tokenizer) -> dict:
    """The weights of the evaluate phase, in the JAX layout: the flagship's
    seeded float32 init (built on the host), ``perturbed``, then scaled as
    the CPU tests scale theirs (``tests/test_torch_slice.py``: the head
    trunks' convs × 10, the token embedding × 20, the vocabulary projection
    × 8), so the captions depend on the image."""
    from fpn_mt_image_captioning_torch.weights import to_flax

    seeded = Pipeline(tokenizer, MAX_LEN, Config(compute_dtype="float32"), seed=0, device="cpu")
    variables = perturbed(to_flax(seeded.transformer))
    params = variables["params"]
    for trunk in ("regression_trunk", "classification_trunk"):
        for conv in params["encoder"]["feature_extractor"][trunk].values():
            conv["kernel"] *= 10.0
    params["decoder"]["embedding"]["embedding"] *= 20.0
    params["final_layer"]["kernel"] *= 8.0
    return variables


def captions_of(pipe, ids, pixels, batch) -> list[dict]:
    """``predict_batch`` over ``pixels`` in the order ``ids``, in batches of
    ``batch`` padded as ``iter_batches`` pads them (the last image repeated):
    the result list ``evaluate`` must give, made without the data layer."""
    import numpy as np

    out = []
    for start in range(0, len(ids), batch):
        chunk = ids[start : start + batch]
        imgs = [pixels[i] for i in chunk]
        seqs, lengths = pipe.predict_batch(np.stack(imgs + imgs[-1:] * (batch - len(chunk))))
        out += [{"image_id": i, "caption": pipe.to_caption(seqs[k], lengths[k])}
                for k, i in enumerate(chunk)]
    return out


def bitwise_equal(a, b) -> bool:
    import torch

    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def evaluate_timed(pipe, split) -> tuple[list, float, float]:
    """``pipe.evaluate(split)``: results, wall seconds, and seconds inside
    ``predict_batch`` (encode and beam search; its outputs come back to the
    host, so each call ends synchronised)."""
    inner, spent = pipe.predict_batch, []

    def timed(images, beam_n=None):
        t0 = time.perf_counter()
        out = inner(images, beam_n)
        spent.append(time.perf_counter() - t0)
        return out

    pipe.predict_batch = timed
    try:
        t0 = time.perf_counter()
        results = pipe.evaluate(split)
        wall = time.perf_counter() - t0
    finally:
        del pipe.predict_batch
    return results, wall, sum(spent)


def trees_equal(a, b) -> bool:
    """Two nested dicts of numpy arrays with the same keys and bitwise-equal
    leaves."""
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(
            trees_equal(a[k], b[k]) for k in b)
    return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def phase_evaluate_kernels(fd, torch, dev, pipe):
    """The decode kernels at the evaluation path's shapes (bf16, beam 4,
    decode_batch 16: 64 rows, Lenc 16, top 4), each held to its plain version
    with the tolerances of phases 3 and 7: (c) at positions 1, 8, 30 and 59
    through a random ancestry of groups of 4 (cache writes bitwise equal),
    (d) over the 16 items' K/V, (e) over 64 rows, and ``fused_decode_step``
    over 8 synchronised steps on the flagship's weights (``pipe``). (a) and
    (b) at 64 rows are held in phase 3."""
    g = torch.Generator().manual_seed(4444)
    beam, items = EVAL_BEAM, EVAL_ITEMS
    bk, lpad, layer = items * beam, 64, 2
    tol = dict(atol=1e-2, rtol=1e-2)
    rand = lambda *shape: torch.randn(*shape, generator=g).to(dev, torch.bfloat16)
    qkv, caches = rand(bk, 3 * D), (rand(NL, lpad, bk, D), rand(NL, lpad, bk, D))
    src_t = torch.randint(0, beam, (lpad, bk), generator=g, dtype=torch.int32).to(dev)
    errs = {}
    for pos in SELF_POSITIONS:
        mine, theirs = [c.clone() for c in caches], [c.clone() for c in caches]
        label = f"decoder_self_attention[pos={pos},beam={beam},rows={bk}]"
        errs[f"self_attention_pos{pos}"] = close(
            label, fd.decoder_self_attention(qkv, *mine, layer, pos, src_t, beam, H),
            fd.decoder_self_attention_reference(qkv, *theirs, layer, pos, src_t, beam, H), **tol)
        if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
            raise SmokeFailure(f"{label}: cache writes differ")
    q, kv_cross = rand(bk, D), rand(NL, LENC, items, 2 * D)
    errs["cross_attention"] = close(
        f"decoder_cross_attention[Lenc={LENC},beam={beam},items={items}]",
        fd.decoder_cross_attention(q, kv_cross, layer, beam, H),
        fd.decoder_cross_attention_reference(q, kv_cross, layer, beam, H), **tol)
    logits, scores, finished = topk_inputs(torch, dev, bk)
    got_s, got_i = fd.decoder_logsoftmax_topk(logits, scores, finished, beam)
    want_s, want_i = fd.decoder_logsoftmax_topk_reference(logits, scores, finished, beam)
    label = f"decoder_logsoftmax_topk[rows={bk},topk={beam}]"
    errs["logsoftmax_topk"] = close(f"{label} scores", got_s, want_s, atol=3e-4)
    if not torch.equal(got_i, want_i):
        raise SmokeFailure(f"{label}: ids differ")
    say("evaluate_shapes", rows=bk, beam=beam, items=items, lenc=LENC, max_abs_err=errs)
    phase_whole_step(fd, torch, dev, pipe, "bfloat16", tag="_evaluate_shapes", items=items,
                     beam=beam, timed=False)


def phase_evaluate(fd, dev, Config, Pipeline, tokenizer, variables, workdir):
    """Evaluation at full width (bf16, beam 4, decode_batch 16) on weights
    whose captions depend on the image (``eval_variables``): the weights
    through a Flax msgpack file and back, ``evaluate`` over a synthetic split
    of ``EVAL_IMAGES`` PNGs (counters reset just before, read just after),
    its results against ``predict_batch`` on the split's pixels as written
    (the ids in the order the seeded shuffle gives, more than one distinct
    caption), ``metric_eval``, the same on the fused backbone, both encodes'
    captions equal in float32, then the ``test.py`` and ``evaluate.py``
    entry points. Returns the launches of the eager and the fused run."""
    import contextlib
    import io
    import random

    from fpn_mt_image_captioning_torch import evaluate as pt_evaluate
    from fpn_mt_image_captioning_torch import test as pt_test
    from fpn_mt_image_captioning_torch.data.dataset import COCO_Images_ImageID, load_image
    from fpn_mt_image_captioning_torch.data.tokenizer import store_tokenizer_to_path
    from fpn_mt_image_captioning_torch.weights import read_flax_msgpack

    root = Path(workdir) / "eval"
    datadir, pixels = write_val_split(root / "data", tokenizer, EVAL_IMAGES)
    store_tokenizer_to_path(tokenizer, root / "tokenizer.json")
    (root / "info.json").write_text(json.dumps({"max_seq_len": MAX_LEN}))
    weights = str(root / "weights.msgpack")
    cfg = Config(datadir=datadir, n_val_dataset=EVAL_IMAGES, is_training=False,
                 tokenizer_filename=str(root / "tokenizer.json"),
                 additional_filename=str(root / "info.json"), transformer_weight_path=weights,
                 transformer_checkpoint_path=str(root / "no_checkpoint"),
                 result_dir=str(root / "results"))
    if (cfg.compute_dtype, cfg.beam_search_n, cfg.decode_batch) != \
            ("bfloat16", EVAL_BEAM, EVAL_ITEMS):
        raise SmokeFailure(f"evaluation defaults moved: {cfg}")

    # the weights through a file: a float32 pipeline writes the bits of
    # ``variables``; from_config reads them into the bf16 model they give
    Pipeline(tokenizer, MAX_LEN, cfg.replace(compute_dtype="float32"), variables,
             device=dev).save_weights(weights)
    if not trees_equal(read_flax_msgpack(weights), variables):
        raise SmokeFailure("the weight file differs from the weights saved")
    pipe = Pipeline.from_config(cfg)
    a = Pipeline(tokenizer, MAX_LEN, cfg, variables, device=dev).transformer.state_dict()
    b = pipe.transformer.state_dict()
    if a.keys() != b.keys() or not all(bitwise_equal(a[k], b[k]) for k in a):
        raise SmokeFailure("weights differ after save_weights and from_config")
    del a, b, variables

    def split():
        return COCO_Images_ImageID(datadir, cfg.datatype_val, EVAL_IMAGES, image_size=SIZE,
                                   seed=cfg.seed)

    order = sorted(pixels)
    random.Random(cfg.seed).shuffle(order)   # the ids in the order evaluation visits them
    batches = -(-EVAL_IMAGES // cfg.decode_batch)
    pipe.evaluate(split())                            # warm-up
    reset_all_counts()
    results, wall, predict_s = evaluate_timed(pipe, split())
    counts = read_all_counts()
    steps = fd.decoder_logsoftmax_topk.launches
    check_decode_counts(fd, decode_per_step(fd), steps)
    if counts["fused_ir_block"] != 0 or not 0 < steps <= batches * MAX_LEN:
        raise SmokeFailure(f"evaluate: {steps} decode steps, {counts['fused_ir_block']} "
                           "backbone launches")
    if [r["image_id"] for r in results] != order:
        raise SmokeFailure(f"evaluate: image ids {[r['image_id'] for r in results]}, "
                           f"want {order}")
    want = captions_of(pipe, order, pixels, cfg.decode_batch)
    if results != want:
        raise SmokeFailure(f"evaluate: {sum(r != w for r, w in zip(results, want))} of "
                           f"{len(want)} results differ from predict_batch")
    distinct = len({r["caption"] for r in results})
    if distinct < 2:
        raise SmokeFailure("evaluate: every caption is the same, so no check here can tell "
                           "the images apart")
    os.makedirs(cfg.result_dir, exist_ok=True)
    with open(cfg.result_file, "w") as out:
        json.dump(results, out)
    t0 = time.perf_counter()
    cider = pipe.metric_eval(cfg.result_file)
    metric_s = time.perf_counter() - t0
    metrics = dict(pipe.metric_eval.eval)
    keys = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"]
    if list(metrics) != keys or not all(math.isfinite(v) for v in metrics.values()) \
            or cider != metrics["CIDEr"]:
        raise SmokeFailure(f"metric_eval: {metrics}")

    # the fused backbone: 17 launches an encode, one encode a batch
    fused = Pipeline.from_config(cfg.replace(fused_backbone=True))
    fused.evaluate(split())                           # warm-up
    reset_all_counts()
    fused_results, fused_wall, fused_predict_s = evaluate_timed(fused, split())
    fused_counts = read_all_counts()
    check_decode_counts(fd, decode_per_step(fd), fd.decoder_logsoftmax_topk.launches)
    if fused_counts["fused_ir_block"] != N_BLOCKS * batches:
        raise SmokeFailure(f"fused evaluate: {fused_counts['fused_ir_block']} backbone "
                           f"launches for {batches} batches × {N_BLOCKS}")
    if fused_results != captions_of(fused, order, pixels, cfg.decode_batch):
        raise SmokeFailure("fused evaluate: results differ from its predict_batch")
    bf16_equal = sum(f == r for f, r in zip(fused_results, results))
    del fused
    # in bf16 the two encodes round apart far enough to flip a beam's choice,
    # so their captions are compared in float32, where they agree to ~1e-5
    cfg32 = cfg.replace(compute_dtype="float32")
    eager32 = Pipeline.from_config(cfg32).evaluate(split())
    fused32 = Pipeline.from_config(cfg32.replace(fused_backbone=True)).evaluate(split())
    if fused32 != eager32 or len({r["caption"] for r in eager32}) < 2:
        raise SmokeFailure(f"float32 evaluate: {sum(f != e for f, e in zip(fused32, eager32))}"
                           f" of {len(eager32)} fused-backbone captions differ from the eager "
                           "encode's, or all are the same")

    # the entry points, each building its pipeline from the files
    first = Path(datadir) / "images" / "val2017" / "9000.png"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        one = pt_test.main(cfg, str(first))
        evaluated = pt_evaluate.main(cfg.replace(result_dir=str(root / "results_main")))
    printed = out.getvalue().splitlines()
    if one != pipe.evaluate_img(load_image(str(first), None, SIZE)[0]) or \
            not (root / "results" / "9000_captions_result.json").is_file():
        raise SmokeFailure(f"test.py: {one}")
    if evaluated != results or printed[-7:] != [f"{k}: {metrics[k]:.4f}" for k in keys]:
        raise SmokeFailure(f"evaluate.py: printed {printed[-8:]}")
    say("evaluate", card=card_line(), images=EVAL_IMAGES, decode_batch=cfg.decode_batch,
        beam=cfg.beam_search_n, batches=batches, decode_steps=steps, wall_s=wall,
        images_per_s=EVAL_IMAGES / wall, decode_s=predict_s, host_s=wall - predict_s,
        metric_eval_s=metric_s, metrics=metrics, distinct_captions=distinct,
        launches={k: n for k, n in counts.items() if k not in PROBE_TPU_KERNELS},
        fused=dict(wall_s=fused_wall, images_per_s=EVAL_IMAGES / fused_wall,
                   decode_s=fused_predict_s, bf16_captions_equal_to_eager=bf16_equal,
                   float32_captions_equal_to_eager=len(eager32),
                   launches={k: n for k, n in fused_counts.items()
                             if k not in PROBE_TPU_KERNELS}),
        weights_bytes=os.path.getsize(weights), weights_round_trip_bitwise=True,
        equal_to_predict_batch=True, test_py=one[0]["caption"][:60],
        evaluate_py_equal=True, captions=sorted({r["caption"][:40] for r in results})[:8])
    return counts, fused_counts


# ---------------------------------------------------------------------------
# phase 14: the non-fused decode modes
# ---------------------------------------------------------------------------
NEAR_TIE = 1e-3   # a candidate gap under this may flip between two routes' roundings


def seqs_in_range(name, seqs, lengths, batch) -> None:
    import numpy as np

    if seqs.shape != (batch, MAX_LEN) or seqs.dtype != np.int32 \
            or not ((lengths >= 0) & (lengths <= MAX_LEN)).all() \
            or (seqs < 0).any() or (seqs >= V).any():
        raise SmokeFailure(f"{name}: sequences {seqs.shape} {seqs.dtype}, tokens or lengths "
                           "out of range")


def with_margins(torch, run):
    """``run()`` — a search on the non-fused step — with each step's
    candidates recorded. Returns its result and, per item, the smallest gap
    that decides it: at every step between the beam-th and the next
    candidate total (which hypotheses survive), and at the last step between
    the first and the second (which one is returned). Where it is wider than
    ``NEAR_TIE``, no rounding of another route flips a choice."""
    from fpn_mt_image_captioning_torch.decode import beam_search as bs

    top, gaps = bs._top, []

    def recording(flat, k):
        v = flat.topk(k + 1, dim=1).values
        gaps.append((v[:, k - 1] - v[:, k], v[:, 0] - v[:, 1]))
        return top(flat, k)

    bs._top = recording
    try:
        out = run()
    finally:
        bs._top = top
    margin = torch.stack([g for g, _ in gaps]).min(0).values
    return out, torch.minimum(margin, gaps[-1][1]).cpu().numpy()


def routed(pipe, **cfg):
    """``pipe`` with other ``Config`` fields, sharing its weights."""
    other = copy.copy(pipe)
    other.config = pipe.config.replace(**cfg)
    return other


def timed(torch, fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def routes_in_lockstep(fd, torch, pipe, enc, beam: int) -> dict:
    """The non-fused and the fused fast beam search driven in lock step over
    ``enc``: at every step each route computes its step on the same state
    (tokens, scores, finished rows, ancestry), the fused step's top-``beam``
    candidates of each row are held to the non-fused totals at the same ids
    (``close``, atol 1e-3) and its ids to the non-fused row's own top ones
    wherever those are clear of a near tie (``ids_agree``); then both states
    follow the non-fused choice. Free-running searches cannot be compared
    so: their deciding gaps fall under 1e-5 within 60 steps on every item
    (permutations of one word set score almost alike). Returns the largest
    score error, the ids compared and the steps."""
    from fpn_mt_image_captioning_torch.decode.beam_search import NEG_INF, _top
    from fpn_mt_image_captioning_torch.models.positional import raw_positional_encoding

    model, packed, dev = pipe.transformer, pipe.packed, enc.device
    batch, bk = enc.shape[0], enc.shape[0] * beam
    cache = model.init_cache(enc.repeat_interleave(beam, dim=0), MAX_LEN + 1)
    fcache = fd.init_fused_cache(packed, enc, beam, MAX_LEN)
    own_rows = torch.arange(bk, device=dev)
    own_local = (own_rows % beam).to(torch.int32)
    src = own_rows[:, None].repeat(1, MAX_LEN + 1)
    src_t = own_local[None, :].repeat(fcache["k_self"].shape[1], 1)
    group_base = torch.arange(batch, device=dev)[:, None] * beam
    emb = model.decoder.embedding.weight.to(packed["wqkv"].dtype)
    pe = torch.as_tensor(raw_positional_encoding(model.max_seq_len + model.max_position, D),
                         device=dev).to(emb.dtype)
    scores = torch.full((batch, beam), NEG_INF, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros((batch, beam), dtype=torch.bool, device=dev)
    tokens = torch.full((bk,), pipe.start_token, dtype=torch.long, device=dev)
    err, compared, t = 0.0, 0, 0
    while t < MAX_LEN and not bool(finished.all()):
        logits, _ = model.decode_step(tokens, t, cache, src)
        lp = torch.log_softmax(logits.float(), dim=-1).reshape(batch, beam, V)
        pad_row = torch.full((V,), NEG_INF, device=dev)
        pad_row[0] = 0.0
        total = scores[..., None] + torch.where(finished[..., None], pad_row, lp)
        top_s, top_i, _ = fd.fused_decode_step(
            packed, fcache, emb[tokens] + pe[t], src_t, t, scores.reshape(bk, 1),
            finished.reshape(bk, 1).float(), num_layers=NL, beam=beam, num_heads=H,
            topk=beam, activation=model.activation)
        rows = total.reshape(bk, V)
        err = max(err, close(f"fused vs non-fused step {t}", top_s,
                             rows.gather(1, top_i.long()), atol=1e-3))
        want_s, want_i = _top(rows, beam + 1)
        compared += ids_agree(f"fused vs non-fused ids, step {t}", top_i, want_s, want_i,
                              NEAR_TIE)
        scores, flat = _top(total.reshape(batch, beam * V), beam)
        beam_idx, new_tokens = flat // V, flat % V
        parents = (group_base + beam_idx).reshape(-1)
        src, src_t = src[parents], src_t[:, parents]
        src[:, t + 1], src_t[t + 1] = own_rows, own_local
        finished = finished.gather(1, beam_idx) | (new_tokens == pipe.end_token)
        tokens = new_tokens.reshape(-1)
        t += 1
    return dict(score_max_abs_err=err, ids_compared=compared, ids_total=t * bk * beam, steps=t)


def phase_decode_modes(fd, torch, pipe, fused, scaled32, scaled16):
    """The non-fused decode modes at full width. ``pipe`` (bf16) and
    ``fused`` (its fused-backbone twin) carry the main path's seeded
    weights; ``scaled32``/``scaled16`` the evaluate phase's
    (``eval_variables``, peaked logits, so greedy choices are clear of near
    ties). (a) the fused and the non-fused fast beam search (beam 8, batch 8
    and 64) in lock step in float32 (``routes_in_lockstep``); free running,
    float32 sequences equal wherever the non-fused search's deciding gaps
    (``with_margins``) stay above ``NEAR_TIE`` (the count printed), and bf16
    through ``use_pallas=False``. (b) parity mode at batch 8: the three
    crafted ties of tests/test_decode.py give their pinned outputs exactly,
    and parity equals greedy on items clear of a near tie, in both dtypes.
    (c) ``sample_batch`` at batch 64, bf16: a seed twice gives the same
    captions, temperature 0 greedy's on clear items, mixed per-row settings
    with ``top_k=5`` run. (d) the decode kernels launch 0 times in (a)'s
    free-running and (b)-(c)'s runs; one fused-backbone sampling run
    launches ``fused_ir_block`` 17 times. (e) the server in
    ``decode="sample"``. (f) ``predict_with_attention``. (g) times (the main
    path's weights), in turns where two routes are compared. Returns the
    launches of the phase's counted runs, summed."""
    import numpy as np

    from fpn_mt_image_captioning_torch import serve
    from fpn_mt_image_captioning_torch.decode.beam_search import beam_search

    rng = np.random.default_rng(1414)
    images = {b: rng.integers(0, 256, (b, SIZE, SIZE, 3), dtype=np.uint8) for b in (8, 64)}
    end = pipe.end_token

    # (a) the non-fused fast beam search against the fused route
    kw = dict(beam_n=BEAM, max_len=MAX_LEN, start_token=pipe.start_token, end_token=end)
    lockstep, free = {}, {}
    for b in (8, 64):
        enc = scaled32.encode(images[b])
        lockstep[b] = routes_in_lockstep(fd, torch, scaled32, enc, BEAM)
        reset_all_counts()
        (s_nf, l_nf, _), margin = with_margins(
            torch, lambda: beam_search(scaled32.transformer, enc, **kw))
        s16, l16 = routed(scaled16, use_pallas=False).predict_batch(images[b])
        if any(k.launches for k in fd.KERNELS):
            raise SmokeFailure(f"the non-fused beam search launched {read_all_counts()}")
        s_f, l_f, _ = beam_search(scaled32.transformer, enc, fused=True, packed=scaled32.packed,
                                  **kw)
        s_nf, l_nf, s_f, l_f = (x.cpu().numpy() for x in (s_nf, l_nf, s_f, l_f))
        seqs_in_range(f"non-fused float32 batch {b}", s_nf, l_nf, b)
        seqs_in_range(f"non-fused bf16 batch {b}", s16, l16, b)
        clear = margin > NEAR_TIE
        bad = clear & ((s_nf != s_f).any(1) | (l_nf != l_f))
        if bad.any():
            raise SmokeFailure(f"non-fused vs fused float32, batch {b}: {int(bad.sum())} items "
                               "clear of a near tie differ")
        s16f, l16f = scaled16.predict_batch(images[b])
        free[b] = dict(float32_items_clear=int(clear.sum()),
                       float32_items_equal=int(((s_nf == s_f).all(1) & (l_nf == l_f)).sum()),
                       float32_min_margin=float(margin.min()),
                       bf16_items_equal=int(((s16 == s16f).all(1) & (l16 == l16f)).sum()))
        say(f"decode_modes_nonfused_batch{b}", lockstep_float32=lockstep[b],
            free_running=free[b], items=b, caption0=scaled16.to_caption(s16[0], l16[0])[:60])
    if not all(v["ids_compared"] for v in lockstep.values()):
        raise SmokeFailure(f"non-fused vs fused: no id clear of a near tie to compare {lockstep}")

    # (b) parity mode: the crafted ties, then parity against greedy
    tok, tok2 = [t for t in range(5, 8) if t != end][:2]
    ties = {"all_way": ({}, MAX_LEN, 0), "two_way": ({tok: 1.0, tok2: 1.0}, MAX_LEN, tok),
            "end_tie": ({end: 1.0, tok: 1.0}, 0, 0)}
    parity_checked = {}
    reset_all_counts()
    for name, p in (("float32", scaled32), ("bfloat16", scaled16)):
        par = routed(p, beam_parity_mode=True)
        final = p.transformer.final_layer
        saved = final.weight.detach().clone(), final.bias.detach().clone()
        try:
            for case, (bias, length, token) in ties.items():
                with torch.no_grad():
                    final.weight.zero_()
                    final.bias.zero_()
                    for t, val in bias.items():
                        final.bias[t] = val
                s, l = par.predict_batch(images[8])
                if not ((l == length).all() and (s == token).all()):
                    raise SmokeFailure(f"parity {name}, crafted {case}: lengths {l.tolist()}, "
                                       f"tokens {np.unique(s).tolist()}; want {length}, {token}")
        finally:
            with torch.no_grad():
                final.weight.copy_(saved[0])
                final.bias.copy_(saved[1])
        s_par, l_par = par.predict_batch(images[8])
        seqs_in_range(f"parity {name}", s_par, l_par, 8)
        (s_g, l_g), margin = with_margins(torch, lambda: greedy_of(p, images[8]))
        clear = margin > NEAR_TIE
        bad = clear & ((s_par != s_g).any(1) | (l_par != l_g))
        if bad.any():
            raise SmokeFailure(f"parity {name}: {int(bad.sum())} items clear of a near tie "
                               "differ from greedy")
        parity_checked[name] = int(clear.sum())
    if not parity_checked["float32"]:
        raise SmokeFailure("parity: no float32 item clear of a near tie to check")
    say("decode_modes_parity", crafted_ties_exact=sorted(ties), batch=8, beam=BEAM,
        items_equal_to_greedy=parity_checked)

    # (c) sampling at batch 64, bf16
    x = images[64]
    a = scaled16.sample_batch(x, seed=5, temperature=1.0)
    b = scaled16.sample_batch(x, seed=5, temperature=1.0)
    if not all((u == w).all() for u, w in zip(a, b)):
        raise SmokeFailure("sample_batch: the same seed gave other captions")
    seqs_in_range("sample_batch", *a, 64)
    zero = scaled16.sample_batch(x, seed=6, temperature=0.0)
    (s_g, l_g), margin = with_margins(torch, lambda: greedy_of(scaled16, x))
    clear = margin > NEAR_TIE
    bad = clear & ((zero[0] != s_g).any(1) | (zero[1] != l_g))
    if bad.any():
        raise SmokeFailure(f"sample_batch at temperature 0: {int(bad.sum())} clear items differ "
                           "from greedy")
    temps = np.resize(np.asarray([0.0, 0.5, 1.0, 2.0], np.float32), 64)
    top_p = np.resize(np.asarray([1.0, 0.9, 0.5, 0.1], np.float32), 64)
    mixed = scaled16.sample_batch(x, seed=7, temperature=temps, top_k=5, top_p=top_p)
    seqs_in_range("sample_batch mixed", *mixed, 64)
    counts = read_all_counts()
    if any(counts[k.__name__] for k in fd.KERNELS):
        raise SmokeFailure(f"parity, greedy or sampling launched decode kernels: {counts}")
    say("decode_modes_sampling", batch=64, same_seed_equal=True,
        temperature0_items_equal_to_greedy=int(clear.sum()),
        distinct_captions=len({s.tobytes() for s in a[0]}), mixed_lengths=mixed[1][:8].tolist(),
        decode_kernel_launches=0)

    # (d) sampling on the fused backbone
    reset_all_counts()
    fused.sample_batch(x, seed=5, temperature=1.0)
    fused_counts = read_all_counts()
    if fused_counts["fused_ir_block"] != N_BLOCKS or any(
            fused_counts[k.__name__] for k in fd.KERNELS):
        raise SmokeFailure(f"fused-backbone sampling launched {fused_counts}")

    # (e) the server in decode="sample" (float32: its greedy reference
    # decodes the same padded batch, where bf16 logits can tie exactly)
    png = png_bytes(images[8][0])
    srv = serve.make_server(scaled32.config, port=0, serve_batch=8, max_delay_ms=300.0,
                            pipeline=scaled32, decode="sample", sample_seed=3)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(query):
        req = urllib.request.Request(f"{base}/caption?{query}", method="POST", data=png)
        try:
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        queries = ["temperature=0.5", "temperature=1.5&top_p=0.9", "top_p=0.5", "temperature=1"]
        with ThreadPoolExecutor(len(queries)) as pool:
            replies = list(pool.map(post, queries))
        bad_params = [post("top_p=0"), post("temperature=nan")]
        zero_status, zero_body = post("temperature=0")      # alone: one padded batch
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        thread.join(timeout=60)
    if any(s != 200 for s, _ in replies) or [s for s, _ in bad_params] != [400, 400] \
            or zero_status != 200:
        raise SmokeFailure(f"sample server: {replies} {bad_params} {zero_status}")
    pixels = serve.decode_image_bytes(png, SIZE, as_uint8=True)
    batch = np.concatenate([pixels[None], np.zeros((7, *pixels.shape), np.uint8)])
    (s_g, l_g), margin = with_margins(torch, lambda: greedy_of(scaled32, batch))
    greedy_caption = scaled32.to_caption(s_g[0], l_g[0])
    if margin[0] > NEAR_TIE and zero_body["caption"] != greedy_caption:
        raise SmokeFailure(f"sample server at temperature 0: {zero_body['caption']!r}, greedy "
                           f"{greedy_caption!r}")
    say("decode_modes_server", requests=len(queries), all_200=True, bad_params_400=True,
        temperature0_equal_to_greedy=bool(margin[0] > NEAR_TIE),
        greedy_margin=float(margin[0]), errors=[b["error"] for _, b in bad_params])

    # (f) the attention read-out (the fused route captions), float32: a bf16
    # weight keeps 8 bits, so a row of 16 sums within ~2e-3 of 1 only
    img = images[8][1]
    reset_all_counts()
    seq, att = scaled32.predict_with_attention(img)
    steps = fd.decoder_logsoftmax_topk.launches
    check_decode_counts(fd, decode_per_step(fd), steps)
    att_counts = read_all_counts()
    s1, l1 = scaled32.predict_batch(img[None])
    if not np.array_equal(seq, s1[0][: l1[0]]):
        raise SmokeFailure("predict_with_attention: its sequence differs from predict_batch's")
    n = min(len(seq) + 1, MAX_LEN)
    want = {f"decoder_layer{i}_block{j}": (1, H, n, n if j == 1 else LENC)
            for i in range(1, NL + 1) for j in (1, 2)}
    if {k: v.shape for k, v in att.items()} != want:
        raise SmokeFailure(f"predict_with_attention: shapes {[v.shape for v in att.values()]}")
    row_err = max(float(np.abs(v.sum(-1) - 1).max()) for v in att.values())
    if row_err > 1e-3 or not all(np.isfinite(v).all() for v in att.values()):
        raise SmokeFailure(f"predict_with_attention: a row sums {row_err} from 1")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        plot = "not written: matplotlib is not installed"
    else:
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "attention.png"
            tokens = [pipe.start_token, *seq]
            scaled32.plot_attention_weights(att, tokens, tokens, f"decoder_layer{NL}_block1", str(path))
            plot = f"written, {path.stat().st_size} bytes"
    say("decode_modes_attention", length=int(len(seq)), keys=len(att), row_sum_max_err=row_err,
        decode_steps=steps, plot=plot)

    # (g) times: the non-fused route against the fused one in turns, parity,
    # sampling with and without the nucleus
    nonfused, parity = routed(pipe, use_pallas=False), routed(pipe, beam_parity_mode=True)
    times = {}
    for b in (8, 64):
        turns = {"non_fused": [], "fused": []}
        for _ in range(3):
            for name, p in (("non_fused", nonfused), ("fused", pipe), ("fused", pipe),
                            ("non_fused", nonfused)):
                turns[name].append(timed(torch, lambda: p.predict_batch(images[b])))
        times[f"batch{b}"] = {k: dict(images_per_s=b / statistics.median(v), runs_s=v)
                              for k, v in turns.items()}
    runs = [timed(torch, lambda: parity.predict_batch(images[8])) for _ in range(3)]
    times["parity_batch8"] = dict(images_per_s=8 / statistics.median(runs), runs_s=runs)
    for name, kw in (("sample_batch64", {}), ("sample_batch64_top_p", {"top_p": 0.9})):
        runs = [timed(torch, lambda: pipe.sample_batch(x, seed=1, **kw)) for _ in range(3)]
        times[name] = dict(images_per_s=64 / statistics.median(runs), runs_s=runs)
    say("decode_modes_times", card=card_line(), bf16=True, beam=BEAM, **times)
    return {k: fused_counts[k] + att_counts[k] for k in att_counts}


def greedy_of(pipe, images):
    """``greedy_decode`` of ``images`` on ``pipe``'s weights, as numpy."""
    from fpn_mt_image_captioning_torch.decode.beam_search import greedy_decode

    seqs, lengths = greedy_decode(
        pipe.transformer, pipe.encode(images), max_len=MAX_LEN,
        start_token=pipe.start_token, end_token=pipe.end_token)
    return seqs.cpu().numpy(), lengths.cpu().numpy()


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "fpn_mt_image_captioning_torch" / "csrc").is_dir():
        print(f"FAIL: the port's package is not beside {Path(__file__).name}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    from fpn_mt_image_captioning_torch.config import Config
    from fpn_mt_image_captioning_torch.data.tokenizer import REFERENCE_FILTERS, Tokenizer
    from fpn_mt_image_captioning_torch.ops import _build
    from fpn_mt_image_captioning_torch.ops import fused_backbone as fb
    from fpn_mt_image_captioning_torch.ops import fused_decoder as fd
    from fpn_mt_image_captioning_torch.runtime import native_loader
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    say("environment", card=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    t0 = time.perf_counter()
    libs = _build.build()   # one nvcc per library, all started together
    nvcc_s = time.perf_counter() - t0
    if not native_loader.available():
        raise SmokeFailure("the native image loader did not build (g++ and zlib)")
    say("build", seconds=time.perf_counter() - t0, nvcc_seconds=nvcc_s,
        libraries=[p.name for p in libs.values()] + [native_loader.library_path().name])

    table = phase_kernels(fd, torch, dev)
    phase_linear_plans(fd, torch, dev)
    table["fused_ir_block"] = phase_backbone_kernels(fb, torch, dev)
    phase_backbone_whole(fb, torch, dev)
    previous = phase_previous_in_turns(fd, fb, torch, dev)
    table["decoder_logsoftmax_topk"]["previous_ms"] = previous[0]
    table["fused_ir_block"]["previous_ms"] = previous[1]
    probe_table, probe_counts = phase_probes(torch, dev)
    table.update(probe_table)

    tokenizer = synthetic_tokenizer(Tokenizer, REFERENCE_FILTERS)
    build = lambda **kw: make_pipeline(torch, dev, fd, fb, Config, Pipeline, tokenizer, **kw)
    pipe = build()
    for dt_name in ("float32", "bfloat16"):
        phase_whole_step(fd, torch, dev, pipe, dt_name)
    wide = build(num_heads=WIDE_H)   # head width 256
    for dt_name in ("float32", "bfloat16"):
        phase_whole_step(fd, torch, dev, wide, dt_name, tag=f"_dh{D // WIDE_H}")
    phase_wide_heads(fd, torch, dev, wide)
    del wide
    phase_small_input(torch, dev, Config, Pipeline, tokenizer)
    counts, eager64 = phase_main(fd, torch, dev, pipe)

    fused = build(fused_backbone=True)
    if fused.backbone_packed is None:
        raise SmokeFailure("fused_backbone=True did not select the fused encode")
    counts["fused_ir_block"] = phase_fused_main(
        fd, fb, torch, fused, pipe, eager64)["fused_ir_block"]
    phase_evaluate_kernels(fd, torch, dev, pipe)
    variables = eval_variables(Config, Pipeline, tokenizer)
    scaled = [Pipeline(tokenizer, MAX_LEN, Config(beam_search_n=BEAM, compute_dtype=dt,
                                                  decode_batch=B), variables, device=dev)
              for dt in ("float32", "bfloat16")]
    modes_counts = phase_decode_modes(fd, torch, pipe, fused, *scaled)
    del pipe, scaled
    with tempfile.TemporaryDirectory() as workdir:
        offline, img_dir = phase_cli(fd, torch, fused, workdir)
        phase_server(torch, fused, offline, img_dir)
        del fused
        eval_counts, fused_eval_counts = phase_evaluate(
            fd, dev, Config, Pipeline, tokenizer, variables, workdir)
    eval_counts["fused_ir_block"] = fused_eval_counts["fused_ir_block"]

    counts.update(probe_counts)
    kernels = []
    for k in all_kernels():
        row = table[k.__name__]
        bound_ms, bound_by = row.pop("bound")
        if k in fd.KERNELS:
            source, replaces = SOURCE, TPU_KERNEL
        elif k in fb.KERNELS:
            source, replaces = BACKBONE_SOURCE, BACKBONE_TPU_KERNEL
        else:
            source, replaces = PROBE_SOURCE, PROBE_TPU_KERNELS[k.__name__]
            if k.__name__.endswith("_trivial"):   # fused_decoder.cu, -DFD_TRIVIAL_BODIES
                source = SOURCE
        kernels.append({"name": k.__name__, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": counts[k.__name__], **row,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "evaluate_launches": eval_counts[k.__name__],
                        "decode_modes_launches": modes_counts[k.__name__]})
    say("timing", **TIMING)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
