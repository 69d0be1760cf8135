#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that the
port builds, is right, and captions on the GPU.

    python3 chip_smoke.py

Phases, in the order they run (each prints one line; any failure raises, so
the script exits non-zero without its last line):

  1. environment — the card (nvidia-smi name and power limit), torch and CUDA
     versions; TF32 is switched off for matmuls and convolutions, so float32
     means float32;
  2. build — every CUDA kernel compiled from the sources in this checkout
     (one nvcc per library, started together), and the native image loader
     (g++), which must report itself available;
  3. decode kernels vs plain — each hand-written kernel of the fused decode
     step held to its plain PyTorch version at the flagship decode shapes
     (B·beam = 512, d 512, 8 heads, dff 2048, 6 layers, Lpad 64, Lenc 16,
     vocab 2000): float32 at the JAX tests' bar (atol 3e-4, ids equal),
     bfloat16 at |err| <= 1e-2 + 1e-2·|plain| (one bf16 rounding of the
     result, 2^-8 relative); with each kernel's time beside its plain
     version's, the one PyTorch call for the same function where there is
     one, and its bound;
  4. backbone kernel vs plain — ``fused_ir_block`` (``csrc/fused_backbone.cu``)
     held to ``fused_ir_block_reference`` at every distinct block shape of a
     flagship encode (512², batch 64; blocks 0, 1, 11, 13 and 16 among them),
     float32 at atol 2e-4 + rtol 1e-3 and bfloat16 at 1e-2 + 1e-2·|plain|;
     with its device time, the plain version's, the eager
     ``_InvertedResidual`` block's (cuDNN convs, float32 BatchNorm) as a
     yardstick, and the bound;
  5. whole backbone — the fused backbone against the plain fused backbone on
     8 images: float32 C3/C4 atol 2e-4, C5 2e-3, + rtol 1e-3; in bfloat16,
     where roundings that the summation order flips cascade through 17
     blocks, the kernel route may stray from the float32 result no further
     than the plain route in bfloat16 does (relative L2, 25 % + 1e-3);
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
     backbone kernel's zero (this encode runs cuDNN);
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
     those PNGs: each 200, each caption the CLI's for that file.

Then the kernel table as one JSON line (every kernel: the decode step's, the
backbone's and the probes'), the card's name and power limit, and
``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
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
SIZE, N_BLOCKS, CLI_FILES, SERVER_REQUESTS = 512, 17, 70, 8


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


# ---------------------------------------------------------------------------
def phase_kernels(fd, torch, dev):
    """Each kernel vs its plain version at the flagship shapes."""
    g = torch.Generator().manual_seed(1234)

    def rand(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)

    table, line = {}, {}
    lpad = 64
    pos, layer = 30, 2
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

        # (c) self-attention at position 30 through a random ancestry
        qkv = rand(BK, 3 * D, dtype=dt)
        k_self, v_self = rand(NL, lpad, BK, D, dtype=dt), rand(NL, lpad, BK, D, dtype=dt)
        src_t = torch.randint(0, BEAM, (lpad, BK), generator=g, dtype=torch.int32).to(dev)
        k1, v1, k2, v2 = k_self.clone(), v_self.clone(), k_self.clone(), v_self.clone()
        got = fd.decoder_self_attention(qkv, k1, v1, layer, pos, src_t, BEAM, H)
        want = fd.decoder_self_attention_reference(qkv, k2, v2, layer, pos, src_t, BEAM, H)
        err = close(f"decoder_self_attention[{dt_name}]", got, want, **tol)
        if not (torch.equal(k1, k2) and torch.equal(v1, v2)):
            raise SmokeFailure(f"decoder_self_attention[{dt_name}]: cache writes differ")
        ms, wall = bench(lambda: fd.decoder_self_attention(qkv, k1, v1, layer, pos, src_t, BEAM, H))
        plain, plain_wall = bench(lambda: fd.decoder_self_attention_reference(
            qkv, k2, v2, layer, pos, src_t, BEAM, H))
        line[f"self_attention_{dt_name}"] = {"err": err, "ms": ms, "plain_ms": plain, "wall_ms": wall, "plain_wall_ms": plain_wall}
        if not f32:
            phys = (torch.arange(BK, device=dev) // BEAM) * BEAM + src_t[:pos].long()
            distinct = int(torch.unique(phys + BK * torch.arange(pos, device=dev)[:, None]).numel())
            nbytes = (BK * 3 * D + 2 * distinct * D + BK * D + 2 * BK * D) * esz + pos * BK * 4
            table["decoder_self_attention"] = dict(
                shape=f"BK={BK} d={D} H={H} pos={pos} bf16", max_abs_err=err, ms=ms,
                plain_ms=plain, library_ms=None,
                bound=bound(nbytes, 4 * BK * D * (pos + 1), dt_name))

        # (d) cross-attention over the per-item encoder K/V
        q = rand(BK, D, dtype=dt)
        kv_cross = rand(NL, LENC, B, 2 * D, dtype=dt)
        got = fd.decoder_cross_attention(q, kv_cross, layer, BEAM, H)
        want = fd.decoder_cross_attention_reference(q, kv_cross, layer, BEAM, H)
        err = close(f"decoder_cross_attention[{dt_name}]", got, want, **tol)
        ms, wall = bench(lambda: fd.decoder_cross_attention(q, kv_cross, layer, BEAM, H))
        plain, plain_wall = bench(lambda: fd.decoder_cross_attention_reference(q, kv_cross, layer, BEAM, H))
        line[f"cross_attention_{dt_name}"] = {"err": err, "ms": ms, "plain_ms": plain, "wall_ms": wall, "plain_wall_ms": plain_wall}
        if not f32:
            dh = D // H
            qs = q.reshape(B, BEAM, H, dh).transpose(1, 2)                     # (B, H, beam, dh)
            kx = kv_cross[layer, :, :, :D].reshape(LENC, B, H, dh).permute(1, 2, 0, 3)
            vx = kv_cross[layer, :, :, D:].reshape(LENC, B, H, dh).permute(1, 2, 0, 3)
            kx, vx = kx.contiguous(), vx.contiguous()
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_out = sdpa(qs, kx, vx).transpose(1, 2).reshape(BK, D)
            close("cross_attention library check", lib_out, want, atol=2e-2, rtol=2e-2)
            lib, lib_wall = bench(lambda: sdpa(qs, kx, vx))
            nbytes = (BK * D + LENC * B * 2 * D + BK * D) * esz
            table["decoder_cross_attention"] = dict(
                shape=f"BK={BK} B={B} Lenc={LENC} d={D} H={H} bf16 (library: SDPA)",
                max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound=bound(nbytes, 4 * BK * D * LENC, dt_name))

    # (e) log-softmax + freeze + top-k: float32 logits spaced apart (no
    # accidental near ties), plus exact ties planted on purpose
    perm = torch.argsort(torch.rand(BK, V, generator=g), dim=1).float()
    logits = (perm / V * 8 - 4).to(dev)
    top = logits.argmax(1)
    rows = torch.arange(16, device=dev)
    logits[rows, V - 1 - rows] = logits[rows, top[:16]]          # exact duplicates
    scores = rand(BK, 1)
    finished = (torch.rand(BK, 1, generator=g) < 0.25).float().to(dev)
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


def phase_whole_step(fd, torch, dev, pipe, dt_name):
    """fused_decode_step vs fused_decode_step_reference, 8 synchronised steps."""
    dt = getattr(torch, dt_name)
    tol = 3e-4 if dt_name == "float32" else 0.1
    model = pipe.transformer
    packed = fd.pack_decoder_weights(model, dt)
    g = torch.Generator().manual_seed(99)
    enc = torch.randn(B, LENC, D, generator=g).to(dev, dt)
    cache_k = fd.init_fused_cache(packed, enc, BEAM, MAX_LEN)
    cache_r = fd.init_fused_cache(packed, enc, BEAM, MAX_LEN)
    lpad = cache_k["k_self"].shape[1]
    own = (torch.arange(BK, device=dev) % BEAM).to(torch.int32)
    src_t = own[None].repeat(lpad, 1)
    emb = model.decoder.embedding.weight.to(dt)
    from fpn_mt_image_captioning_torch.models.positional import raw_positional_encoding

    pe = torch.as_tensor(raw_positional_encoding(MAX_LEN, D), device=dev).to(dt)
    tokens = torch.full((BK,), pipe.start_token, device=dev, dtype=torch.long)
    scores = torch.zeros(BK, 1, device=dev)
    finished = torch.zeros(BK, 1, device=dev)
    kw = dict(num_layers=model.num_layers, beam=BEAM, num_heads=model.num_heads,
              activation=model.activation)
    worst, compared = 0.0, 0
    for t in range(8):
        x = emb[tokens] + pe[t]
        ks, ki, cache_k = fd.fused_decode_step(packed, cache_k, x, src_t, t, scores, finished,
                                               topk=BEAM, **kw)
        rs, ri, cache_r = fd.fused_decode_step_reference(
            packed, cache_r, x, src_t, t, scores, finished, topk=BEAM + 1, **kw)
        worst = max(worst, close(f"whole step {dt_name} t={t}", ks, rs[:, :BEAM], atol=tol))
        compared += ids_agree(f"whole step {dt_name} t={t}", ki, rs, ri, tol)
        tokens, scores = ki[:, 0].long(), ks[:, :1].contiguous()
        if t == 3:   # beam reorder: every beam adopts beam 0's ancestry
            src_t = src_t[:, (torch.arange(BK, device=dev) // BEAM) * BEAM]
        if t == 5:   # a third of the rows finish
            finished = (torch.arange(BK, device=dev) % 3 == 0).float()[:, None]
        src_t[t + 1] = own
    cache_err = max(close(f"whole step {dt_name} {c}", cache_k[c], cache_r[c], atol=tol)
                    for c in ("k_self", "v_self"))
    step = bench(lambda: fd.fused_decode_step(
        packed, cache_k, x, src_t, 8, scores, finished, topk=BEAM, **kw), iters=5, reps=3)
    plain = bench(lambda: fd.fused_decode_step_reference(
        packed, cache_r, x, src_t, 8, scores, finished, topk=BEAM, **kw), iters=5, reps=3)
    say(f"whole_step_{dt_name}", max_abs_err=worst, cache_err=cache_err, ids_compared=compared,
        ids_total=8 * BK * BEAM, pos=8, step_device_ms=step[0], step_wall_ms=step[1],
        plain_device_ms=plain[0], plain_wall_ms=plain[1])


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


def profile_run(torch, fn) -> dict:
    """One traced run of ``fn`` (after an untraced one in the same profiler
    window): wall time, the device's busy time (sum of
    kernel and copy durations; kernels of one stream do not overlap) and
    idle share, and the device time by kernel name, largest first. A window
    that records nothing is run again, up to three times; then this
    raises."""
    from fpn_mt_image_captioning_torch.utils.profiling import cuda_kernel_times

    for _ in range(3):
        rows, wall_ms = cuda_kernel_times(fn)
        if rows:
            break
    else:
        raise SmokeFailure("the CUDA profiler recorded no device time in three windows")
    rows = sorted(((k, us / 1e3, c) for k, us, c in rows), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return dict(wall_ms=wall_ms, device_busy_ms=busy, device_idle_share=1 - busy / wall_ms,
                top=[{"kernel": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:12]])


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
        trace = profile_run(torch, lambda: pipe.predict_batch(images))
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
    distinct = {}
    for sh in shapes:   # blocks that repeat a shape are timed once, counted n times
        key = (sh["hw"], sh["cin"], sh["cexp"], sh["cout"], sh["stride"], sh["residual"])
        distinct.setdefault(key, []).append(sh["index"])
    g = torch.Generator().manual_seed(31)
    rows, totals = {}, {}
    for dt_name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        f32 = dt == torch.float32
        tol = dict(atol=2e-4, rtol=1e-3) if f32 else dict(atol=1e-2, rtol=1e-2)
        packed = fb.packed_to(fb.pack_backbone_weights(net, dt), dev)
        tot = dict(ms=0.0, plain_ms=0.0, eager_ms=0.0, bound_ms=0.0, bytes_bound_ms=0.0,
                   bytes_bound_blocks_ms=0.0, max_abs_err=0.0)
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
            with torch.no_grad():
                eager, _ = bench(lambda: eager_block(xc), iters=5, reps=2)
            del eager_block, xc, x
            t_bytes, t_ops = block_bound_parts(sh, 4 if f32 else 2, dt_name)
            n = len(indices)
            for k, v in (("ms", ms), ("plain_ms", plain), ("eager_ms", eager),
                         ("bound_ms", max(t_bytes, t_ops))):
                tot[k] += n * v
            tot["bytes_bound_ms"] += n * t_bytes
            if t_bytes >= t_ops:
                tot["bytes_bound_blocks_ms"] += n * t_bytes
            tot["max_abs_err"] = max(tot["max_abs_err"], err)
            rows[f"{dt_name}_blocks_{'_'.join(map(str, indices))}"] = dict(
                shape=f"{sh['hw']}² {sh['cin']}→{sh['cexp']}→{sh['cout']} s{sh['stride']}"
                      f"{' +res' if sh['residual'] else ''}",
                max_abs_err=err, ms=ms, plain_ms=plain, eager_ms=eager,
                bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes_bound_ms=t_bytes)
        totals[dt_name] = tot
    say("backbone_kernels", batch=B, size=SIZE, blocks=rows, per_encode=totals)
    bf = totals["bfloat16"]
    return dict(shape=f"the 17 blocks of one encode, batch {B}, {SIZE}², bf16 (sums over the "
                      "17 launches; per-block rows in the backbone_kernels line)",
                max_abs_err=bf["max_abs_err"], ms=bf["ms"], plain_ms=bf["plain_ms"],
                eager_ms=bf["eager_ms"], library_ms=None,
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


def make_pipeline(torch, dev, fd, fb, Config, Pipeline, tokenizer, **cfg_kw):
    """The flagship pipeline with seeded weights whose BatchNorm statistics
    and biases are perturbed (they init to 0/1), decoder (and fused backbone)
    weights packed again after the perturbation."""
    from fpn_mt_image_captioning_torch.models.backbones.mobilenet_v2 import BatchNorm32

    cfg = Config(beam_search_n=BEAM, compute_dtype="bfloat16", decode_batch=B, **cfg_kw)
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
    probe_table, probe_counts = phase_probes(torch, dev)
    table.update(probe_table)

    tokenizer = synthetic_tokenizer(Tokenizer, REFERENCE_FILTERS)
    build = lambda **kw: make_pipeline(torch, dev, fd, fb, Config, Pipeline, tokenizer, **kw)
    pipe = build()
    for dt_name in ("float32", "bfloat16"):
        phase_whole_step(fd, torch, dev, pipe, dt_name)
    phase_small_input(torch, dev, Config, Pipeline, tokenizer)
    counts, eager64 = phase_main(fd, torch, dev, pipe)

    fused = build(fused_backbone=True)
    if fused.backbone_packed is None:
        raise SmokeFailure("fused_backbone=True did not select the fused encode")
    counts["fused_ir_block"] = phase_fused_main(
        fd, fb, torch, fused, pipe, eager64)["fused_ir_block"]
    del pipe
    with tempfile.TemporaryDirectory() as workdir:
        offline, img_dir = phase_cli(fd, torch, fused, workdir)
        phase_server(torch, fused, offline, img_dir)

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
                        "bound_ms": bound_ms, "bound_by": bound_by})
    say("timing", **TIMING)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
