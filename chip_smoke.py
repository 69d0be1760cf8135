#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that the
port builds, is right, and captions and trains on the GPU.

    python3 chip_smoke.py

Phases, in the order they run, except that 14 runs between the kernel
checks that open 13 and phase 11, and 15 to 19 last (each prints one
line; any failure raises, so the script exits non-zero without its last
line):

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
     cross-attention at Lenc 16 beside SDPA, with their bounds; and
     cross-attention at head width 256 beside SDPA over the same items in
     bf16 and float32): float32 at the JAX
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
     backbone kernel's zero (this encode runs cuDNN); the wrappers count
     what they issue: the eager calls' launches and a shape's capture, one
     step's a position, and none for a CUDA-graph replay, so the decode
     steps of the timed calls are their ``beam.kernels`` spans, and in the
     traced run (which replays) each decode kernel's launches in the
     profiler's trace must be its steps × its launches a step; each
     attention kernel's mean device time a launch in the traced batch-64
     run beside its isolated times from phase 3;
 10. fused main path — the same ``predict_batch`` at batch 64 with
     ``fused_backbone=True`` (same weights): counters reset just before and
     read just after, ``fused_ir_block`` at 17 × the encodes, and the traced
     run's decode kernels counted in the trace as in phase 9; then the fused
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
     reset just before and read just after, each decode kernel at the steps
     its wrapper issued × its launches a step, none where every step
     replayed a CUDA graph, the decode steps from the spans, the backbone
     kernel at zero): the image
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

 15. training — the flagship's ``train_step`` at batch 10 and 64, a small
     model's step on the card against the CPU, the ``train`` main over two
     epochs (``phase_train_*``).
 16. backbones and the Keras ``.h5`` import — (a) the eight new backbones
     (ResNet-50/101/152, VGG16/19, DenseNet-121/169/201) at the flagship's
     widths with seeded weights (BatchNorm statistics calibrated on a seeded
     batch): float32 C3/C4/C5 at 512², batch 2, card against the CPU route
     for the smallest depth of each family (atol 2e-4 + rtol 1e-3), bf16
     taps within 1.25× (+ 1e-3) of another bf16 route's relative L2 from
     float32 (phase 5's method; the other route is ``channels_last``); then
     ``predict_batch`` in bf16 at batch 64 with ``fused_backbone=True``
     (eager encode: no packed backbone, ``fused_ir_block`` 0), counters reset
     just before the timed runs and read just after, each decode kernel at
     the steps × its launches a step; encode s, images/s, peak memory.
     (b) ``train_step`` of ResNet-50, VGG16 and DenseNet-121 five times at
     batch 10 on one seeded batch (loss finite and falling, step wall,
     images/s, peak memory, idle share of a traced step), ResNet-152 and
     DenseNet-201 once; the peak at batch 64 predicted from batch 10's, and
     one step run where it fits. (c) the golden Keras ``.h5`` read by the
     port's reader (no ``h5py`` there) and imported into a backbone whose
     float32 taps hold Keras' activations (atol 2e-4 + rtol 1e-3); the
     ``train`` main booted from it for 2 steps; a Keras-named dict of the
     flagship imported into a flagship seeded otherwise: weights bitwise and
     encode equal to the source's. The phase prints its seconds.

 17. serving artifact (``fpn_mt_image_captioning_torch/export.py``), last:
     (a) the flagship's beam programs exported at ``decode_batch`` 16 (128
     decode rows; each decode kernel's operator 60 × its launches a step in
     the graph, no launch while exporting) and loaded; a request of 61
     uint8 images (four chunks, the last padded) bitwise equal to
     ``Pipeline.predict_batch`` chunked alike, the captions equal, each
     decode kernel at 60 × 4 × its launches a step (the trip count is
     fixed), ``fused_ir_block`` 0; the float program equal to the uint8 one
     on the images normalized on the host through the card's own byte
     table; (b) the four sampling programs, exported at the flagship's
     widths cut to 1+1 layers and 16 steps (a sampling program inlines the
     non-fused step a layer and a step: depth is its export and load
     cost), uint8 and float, with and
     without ``top_p``, each equal to ``Pipeline.sample_batch`` on a chunk
     of 16 (seed 7, per-row temperature); (c) a fresh process that loads
     the artifact and captions 16 images as (a) did, without importing the
     model module; (d) ``caption.main`` over 20 PNGs and the server (8
     concurrent requests) on the artifact: the captions of (a); the
     artifact against the pipeline in turns at 16 and 64 images (medians
     of 5, the steps of each call), one traced run of each (device busy,
     idle share, copy kernels); (e, f) the ``train`` main over phase 15's
     corpus at 2+2 layers with the fused backbone, for 2 steps, with
     ``profile_dir`` (the trace holds CUDA kernel events) and
     ``export_artifact_dir``: a fused-backbone artifact with beam programs
     only, which loads and equals the trained pipeline's ``predict_batch``
     over two chunks, ``fused_ir_block`` at 17 launches a chunk and each
     decode kernel at the corpus' max_seq_len × 2 × its launches a step. Each step prints its line with the
     card's name and power limit; export, load seconds, nodes and bytes of
     every program.
 18. several ranks (``fpn_mt_image_captioning_torch/parallel/``), last: one
     pair of rank processes (``--phase18-rank``) on ``cuda:0`` over gloo
     (NCCL refuses two ranks on one card), ``LOCAL_RANK`` 0 in each, as two
     one-card hosts. (a) the sharded train step of the flagship in float32
     (TF32 off), a global batch of 16, 3 steps, dropout 0.1, on meshes
     (2, 1) and (1, 2), each held to one process's steps on the card (run
     here first) at the JAX test's bar: losses rtol 1e-5, weights atol
     2e-5, BatchNorm statistics rtol 1e-5, Adam's first moments at phase
     15's gradient bar; the step walls beside one process's (the ranks
     time-share the card: no scaling figure). (b) the sharded
     ``predict_batch`` at (2, 1), bf16, fused, 8 images a rank, 60 steps:
     the gathered sequences equal one process's on the same 8-image
     batches, each decode kernel's launches a rank the steps × its count a
     step (rank 0's are the ``parallel_launches`` of the kernel line), after
     a warm-up call. After (a)'s 3 steps, one more step a mesh with its
     collectives timed (the card synchronised before each): their seconds
     and share of that step's wall. (c)
     the ``train`` main under ``python -m torch.distributed.run
     --nproc_per_node=2`` (``--phase18-train-main``; gloo, both ranks on
     ``cuda:0``) over phase 15's 24 PNGs at 2+2 layers, mesh on, 2 epochs
     with an evaluation each (CIDEr + epoch, so epoch 2 saves): both ranks
     the same losses, disjoint equal shards covering the corpus, one log
     directory, one result file, one checkpoint series. (d) a world of one
     rank on NCCL here, an explicit 1 × 1 mesh: the sharded step against
     ``train_step`` and the sharded beam search against ``beam_search``.
     Its seconds (budget 180 s) on its last line.
 19. the last modules, last (budget 150 s, its seconds on its last line;
     each line with the card's name and power limit): (a) the d256 proxy
     (256², d 256, 3+3 layers, dff 1024, 8 heads, batch 16) on the synthetic
     classful corpus (200 + 18 images) for 20 epochs through the ``train``
     main (``scripts/convergence_run.py``), an evaluation every 5 on the
     decode kernels, then its best checkpoint at beam 8: counters reset just
     before and read just after, each decode kernel at the decode steps ×
     its launches a step (``convergence_launches`` in the kernel line),
     ``fused_ir_block`` 0; the curve held to the convergence test's bars
     (last-quarter loss below 0.7 × the first quarter's, CIDEr improving,
     best above 0.5); the step wall, images/s and each evaluation's
     seconds. (b) The golden Orbax checkpoint ``tests/golden_torch/orbax/1``
     (written by the JAX package's manager) read by the port's reader with
     this machine's libzstd, bitwise equal to the values its seed
     regenerates. (c) The golden Keras ``.h5``'s layers written by the
     port's ``write_keras_h5`` and read back bitwise; the backbone imported
     from the written file has phase 16 (c)'s taps exactly. (d) The anchors
     and ``box_decode`` at 512² and the four detection losses with their
     gradients on ``cuda:0`` against the CPU (boxes within 1e-4 + 1e-6
     relative, losses and gradients within 1e-5 relative).

Then the kernel table as one JSON line (every kernel: the decode step's, the
backbone's and the probes'; ``launches`` from the main path's runs,
``evaluate_launches`` from phase 13's, ``decode_modes_launches`` from phase
14's counted runs, ``train_launches`` from phase 15's ``train`` main,
``backbones_launches`` from phase 16 (a)'s counted runs,
``artifact_launches`` from phase 17 (a)'s request, ``parallel_launches``
from phase 18 (b)'s rank 0, ``convergence_launches`` from phase 19 (a)), the
card's name and power limit, and
``{"ok": true, "device": {...}}`` as the last line. ``--phase18-rank`` and
``--phase18-train-main`` are phase 18's own worker modes.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import math
import os
import re
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
# each decode wrapper's kernels (csrc/fused_decoder.cu), by name in a profiler's trace
DECODE_KERNELS = {
    "decoder_linear": re.compile(r"\b(linear|linear_wgmma)_kernel\b"),
    "decoder_add_layernorm": re.compile(r"\badd_layernorm_kernel\b"),
    "decoder_self_attention": re.compile(r"\bself_attention(_wide)?_kernel\b"),
    "decoder_cross_attention": re.compile(r"\bcross_attention(_mma|_wide)?_kernel\b"),
    "decoder_logsoftmax_topk": re.compile(r"\blogsoftmax_topk(_rounds)?_kernel\b"),
}


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


def sdpa_cross(torch, q, kv_cross, layer, items, heads, lenc):
    """SDPA over the same cross-attention as (d), each item's beams over its
    K/V (laid out for it beforehand): the call to time, and the result as
    (items·beam, d)."""
    dh = D // heads
    qs = q.reshape(items, BEAM, heads, dh).transpose(1, 2)
    kx = kv_cross[layer, :, :, :D].reshape(lenc, items, heads, dh).permute(1, 2, 0, 3).contiguous()
    vx = kv_cross[layer, :, :, D:].reshape(lenc, items, heads, dh).permute(1, 2, 0, 3).contiguous()
    call = lambda: torch.nn.functional.scaled_dot_product_attention(qs, kx, vx)
    return call, lambda: call().transpose(1, 2).reshape(items * BEAM, D)


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
    sdpa_call, sdpa_out = sdpa_cross(torch, q, kv_cross, layer, items, H, LENC)
    close(f"decoder_cross_attention[rows={bk}] library check", sdpa_out(),
          fd.decoder_cross_attention_reference(q, kv_cross, layer, BEAM, H), atol=2e-2, rtol=2e-2)
    entry["library_ms"], entry["library_wall_ms"] = bench(sdpa_call)
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
                sdpa_call, sdpa_out = sdpa_cross(torch, q, kv_cross, layer, B, H, lenc)
                close(f"{label} library check", sdpa_out(), want, atol=2e-2, rtol=2e-2)
                lib, lib_wall = bench(sdpa_call)
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
            if lenc == LENC:   # head width 256: the wide kernel, beside SDPA
                wide = f"decoder_cross_attention[dh={D // WIDE_H},Lenc={lenc},{dt_name}]"
                entry = attention_case(
                    fd, torch, wide, tol,
                    lambda: fd.decoder_cross_attention(q, kv_cross, layer, BEAM, WIDE_H),
                    lambda: fd.decoder_cross_attention_reference(q, kv_cross, layer, BEAM, WIDE_H))
                sdpa_call, sdpa_out = sdpa_cross(torch, q, kv_cross, layer, B, WIDE_H, lenc)
                close(f"{wide} library check", sdpa_out(),
                      fd.decoder_cross_attention_reference(q, kv_cross, layer, BEAM, WIDE_H),
                      atol=2e-2 if not f32 else 3e-4, rtol=2e-2 if not f32 else 0.0)
                entry["library_ms"], entry["library_wall_ms"] = bench(sdpa_call)
                entry["bound_ms"] = cross_attention_bound(lenc, B, dt_name)[0]
                line[f"cross_attention_dh{D // WIDE_H}_lenc{lenc}_{dt_name}"] = entry
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
    idle share, the device time by kernel name, largest first, for each
    name part in ``means`` the launches and mean µs a launch of the kernels
    whose names hold it, and each decode wrapper's launches (``decode``;
    a CUDA-graph replay's kernels are in the trace, though no wrapper counts
    them). A window that records nothing is run again, up to three times;
    then this raises."""
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
               top=[{"kernel": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:12]],
               decode={w: sum(c for k, _, c in rows if pat.search(k))
                       for w, pat in DECODE_KERNELS.items()})
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.predict_batch(images)                  # warm-up
        torch.cuda.synchronize()
        warmup_s = time.perf_counter() - t0
        walls, encodes = [], []
        start = decode_steps()
        for _ in range(5):
            t0 = time.perf_counter()
            seqs, lengths = pipe.predict_batch(images)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        n_steps = (decode_steps() - start) // 5
        for _ in range(5):
            t0 = time.perf_counter()
            pipe.encode(images)
            torch.cuda.synchronize()
            encodes.append(time.perf_counter() - t0)
        trace = profile_run(torch, lambda: pipe.predict_batch(images), means=ATTENTION_KERNELS)
        check_trace_decode_counts(fd, trace, n_steps)
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
    """Each decode kernel's launches since the counters' reset at ``steps``
    × its launches a step (the steps the wrappers issued, eagerly or into a
    graph's capture), and decode work done: launches, or steps that
    replayed a CUDA graph, whose kernels no wrapper counts."""
    replays = replayed_steps()
    for k, n in per_step.items():
        if k.launches != steps * n or not (k.launches or replays):
            raise SmokeFailure(f"{k.__name__}: {k.launches} launches for {steps} steps "
                               f"× {n} per step, {replays} steps replayed")


def check_trace_decode_counts(fd, trace: dict, steps: int) -> None:
    """The traced call's decode kernels in the profiler's trace: each at
    ``steps`` (the call's decode steps, from its spans) × its launches a
    step, so the trace holds every kernel a replayed graph ran."""
    got = trace["decode"]
    want = {k.__name__: steps * n for k, n in decode_per_step(fd).items()}
    if not steps or got != want:
        raise SmokeFailure(f"traced decode launches {got}, expected {want} ({steps} steps)")


def decode_steps() -> int:
    """The decode steps beam searches have run in this process, on either
    route (their ``beam.kernels`` spans; none under the profiler)."""
    from fpn_mt_image_captioning_torch.utils.profiling import REGISTRY

    return REGISTRY.summary("beam.kernels").get("steps", 0)


_REPLAYS_AT_RESET = [0]


def replay_spans() -> int:
    from fpn_mt_image_captioning_torch.utils.profiling import REGISTRY

    return REGISTRY.summary("beam.replay").get("steps", 0)


def replayed_steps() -> int:
    """The decode steps that replayed a CUDA graph since the counters' last
    reset (``beam.replay`` spans; all of them if the spans were reset since)."""
    now = replay_spans()
    return now - _REPLAYS_AT_RESET[0] if now >= _REPLAYS_AT_RESET[0] else now


def all_kernels():
    from fpn_mt_image_captioning_torch.ops import fused_backbone, fused_decoder, probes

    return fused_decoder.KERNELS + fused_backbone.KERNELS + probes.KERNELS


def reset_all_counts() -> None:
    from fpn_mt_image_captioning_torch.ops import fused_backbone, fused_decoder, probes

    fused_decoder.reset_launch_counts()
    fused_backbone.reset_launch_counts()
    probes.reset_launch_counts()
    _REPLAYS_AT_RESET[0] = replay_spans()


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


def make_pipeline(torch, dev, fd, fb, Config, Pipeline, tokenizer, max_len=MAX_LEN, **cfg_kw):
    """The flagship pipeline with seeded weights whose BatchNorm statistics
    and biases are perturbed (they init to 0/1), decoder (and fused backbone)
    weights packed again after the perturbation, which is made on the card's
    copy after the cast; ``max_len`` tokens a caption."""
    from fpn_mt_image_captioning_torch.models.backbones.mobilenet_v2 import BatchNorm32

    cfg = Config(**{"beam_search_n": BEAM, "compute_dtype": "bfloat16", "decode_batch": B,
                    **cfg_kw})
    pipe = Pipeline(tokenizer, max_len, cfg, seed=0, device=dev)
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
    start = decode_steps()
    walls, encs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        seqs, lengths = pipe.predict_batch(images)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        encodes += 1
    n_steps = (decode_steps() - start) // 5
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
    check_trace_decode_counts(fd, trace, n_steps)
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


def write_val_split(root: Path, tokenizer, n: int, split: str = "val2017",
                    first_id: int = 9000, seed: int = 31) -> tuple[str, dict]:
    """A synthetic COCO split ``split`` under ``root``: ``n`` seeded 512²
    PNGs, one caption each from the tokenizer's words. Each image is a dim
    noise floor over a colour of its own with a bright band at a place of its
    own, so the encoder tells them apart (uniform noise looks alike to it).
    Returns ``root`` and the pixels by image id."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = [w for w in tokenizer.index_word.values() if w.startswith("w")]
    img_dir = root / "images" / split
    img_dir.mkdir(parents=True)
    (root / "annotations").mkdir(exist_ok=True)
    images, anns, pixels = [], [], {}
    for i in range(n):
        img_id = first_id + i
        a = rng.integers(0, 60, (SIZE, SIZE, 3)) + rng.integers(0, 120, 3)
        lo = rng.integers(0, SIZE - SIZE // 8)
        a[lo:lo + SIZE // 8] = 255
        pixels[img_id] = a.astype(np.uint8)
        (img_dir / f"{img_id}.png").write_bytes(png_bytes(pixels[img_id]))
        images.append({"id": img_id, "file_name": f"{img_id}.png"})
        anns.append({"id": i + 1, "image_id": img_id,
                     "caption": " ".join(rng.choice(words, rng.integers(5, 13)))})
    (root / "annotations" / f"captions_{split}.json").write_text(
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
    start = decode_steps()
    results, wall, predict_s = evaluate_timed(pipe, split())
    counts = read_all_counts()
    steps = decode_steps() - start
    check_decode_counts(fd, decode_per_step(fd), fd.decoder_logsoftmax_topk.launches)
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


# ---------------------------------------------------------------------------
# phase 15: training
# ---------------------------------------------------------------------------
TRAIN_BATCHES, TRAIN_STEPS, TRAIN_WARMUP = (10, 64), 10, 10
TRAIN_MAIN_IMAGES, TRAIN_MAIN_VAL = 24, 16   # the train main's split: 3 batches of 10, 16 val


def train_batch(rng, batch: int, max_len: int):
    """``batch`` seeded uint8 images and captions: <start>-free token ids in
    [4, V) with a zero tail of each row's own length (5 tokens or more)."""
    import numpy as np

    images = rng.integers(0, 256, (batch, SIZE, SIZE, 3), dtype=np.uint8)
    caps = rng.integers(4, V, (batch, max_len)).astype(np.int32)
    for row, n in zip(caps, rng.integers(5, max_len + 1, batch)):
        row[n:] = 0
    return images, caps


def bn_stats(torch, model) -> list:
    from fpn_mt_image_captioning_torch.models.backbones.mobilenet_v2 import BatchNorm32

    return [(m.running_mean.clone(), m.running_var.clone())
            for m in model.modules() if isinstance(m, BatchNorm32)]


def phase_train_flagship(torch, dev, Config, Pipeline, tokenizer, workdir) -> dict:
    """(a) ``Pipeline.train_step`` of the flagship (512², mobilenet224_1.0,
    d 512, 6+6 layers, dff 2048, 8 heads, vocab 2000, max_seq_len 60, bf16
    compute, float32 parameters, dropout 0.1, warm_up_steps 10) on one fixed
    seeded batch of 10 and of 64, ``TRAIN_STEPS`` steps each: every loss
    finite, the loss falling, the BatchNorm running statistics moved, every
    parameter and statistic float32; the median step wall time, images/s,
    the peak of allocated memory, and a CUDA-profiler window of two steps."""
    import numpy as np

    out = {}
    for batch in TRAIN_BATCHES:
        cfg = Config(batch_size=batch, warm_up_steps=TRAIN_WARMUP)
        if (cfg.compute_dtype, cfg.dropout_rate, cfg.d_model, cfg.num_layers) != \
                ("bfloat16", 0.1, D, NL):
            raise SmokeFailure(f"training defaults moved: {cfg}")
        pipe = Pipeline(tokenizer, MAX_LEN, cfg, seed=0, device=dev,
                        checkpoint_path=str(Path(workdir) / f"train_ckpt{batch}"))
        images, caps = train_batch(np.random.default_rng(batch), batch, MAX_LEN)
        before = bn_stats(torch, pipe.state.model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, walls = [], []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            losses.append(pipe.train_step(images, caps))   # reads the loss back: synchronised
            walls.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses):
            raise SmokeFailure(f"train batch {batch}: losses {losses}")
        if not (losses[-1] < losses[0] and sum(losses[-3:]) < sum(losses[:3])):
            raise SmokeFailure(f"train batch {batch}: the loss does not fall: {losses}")
        after = bn_stats(torch, pipe.state.model)
        moved = sum(not torch.equal(a[0], b[0]) for a, b in zip(before, after))
        if moved != len(before):
            raise SmokeFailure(f"train batch {batch}: {len(before) - moved} of {len(before)} "
                               "BatchNorm layers kept their running mean")
        if any(t.dtype != torch.float32 for t in pipe.state.model.state_dict().values()):
            raise SmokeFailure(f"train batch {batch}: a master weight is not float32")
        trace = profile_run(torch, lambda: [pipe.train_step(images, caps) for _ in range(2)])
        wall = statistics.median(walls)
        out[batch] = dict(step_s=wall, step_s_runs=walls, images_per_s=batch / wall,
                          losses=losses, max_memory_allocated_bytes=peak,
                          bn_layers_moved=moved, trace=trace)
        del pipe
        torch.cuda.empty_cache()
    traces = {b: out[b].pop("trace") for b in out}
    say("train_flagship", card=card_line(), steps=TRAIN_STEPS, warm_up_steps=TRAIN_WARMUP,
        **{f"batch{b}": out[b] for b in out})
    for b, trace in traces.items():
        say(f"train_trace_batch{b}", steps_in_window=2, **trace)
    return out


def grads_of(torch, model, images, caps) -> tuple[float, dict]:
    """The training loss and every parameter's gradient (no dropout)."""
    from fpn_mt_image_captioning_torch.models.positional import create_masks
    from fpn_mt_image_captioning_torch.train.losses import masked_sparse_ce

    dev = next(model.parameters()).device
    images = torch.as_tensor(images, device=dev)
    caps = torch.as_tensor(caps, device=dev).long()
    logits, _ = model.forward_train(images, caps[:, :-1], create_masks(caps[:, :-1]))
    loss = masked_sparse_ce(caps[:, 1:], logits)
    names = [n for n, _ in model.named_parameters()]
    return loss.item(), dict(zip(names, torch.autograd.grad(loss, list(model.parameters()))))


def phase_train_card_vs_cpu(torch, dev, Config, Pipeline, tokenizer, workdir):
    """(b) A small float32 model (256², mobilenet224_0.35, d 32, 2+2 layers,
    dropout 0) from the same weights on the card and on the CPU: the loss
    (rtol 1e-4), every gradient (per tensor ‖Δ‖ ≤ 5e-2·(‖g_cpu‖ + 1e-3·max‖g‖),
    median ≤ 1e-2: training-mode BatchNorm makes float32 gradients this
    ill-conditioned, as the CPU tests against JAX measure), then two
    ``train_step``s (lr(0) = 0, so the second moves the weights): each weight
    within 2.5·alpha of the CPU's, the median within 2e-2·alpha."""
    import numpy as np

    from fpn_mt_image_captioning_torch.train.schedule import keras_alpha
    from fpn_mt_image_captioning_torch.weights import to_flax

    cfg = Config(image_input_size=256, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
                 num_heads=4, dff=64, compute_dtype="float32", dropout_rate=0.0,
                 warm_up_steps=TRAIN_WARMUP, batch_size=3)
    max_len = 12
    variables = to_flax(Pipeline(tokenizer, max_len, cfg, seed=3, device="cpu").transformer)
    rng = np.random.default_rng(15)
    images = rng.integers(0, 256, (3, 256, 256, 3), dtype=np.uint8)
    caps = rng.integers(4, V, (3, max_len)).astype(np.int32)
    caps[1, 6:] = 0
    cpu, card = (Pipeline(tokenizer, max_len, cfg, variables, device=d,
                          checkpoint_path=str(Path(workdir) / f"vs_cpu_{name}"))
                 for d, name in (("cpu", "cpu"), (dev, "card")))
    cpu_loss, cpu_g = grads_of(torch, cpu.state.model, images, caps)
    gpu_loss, gpu_g = grads_of(torch, card.state.model, images, caps)
    if not math.isclose(gpu_loss, cpu_loss, rel_tol=1e-4):
        raise SmokeFailure(f"train loss: card {gpu_loss}, CPU {cpu_loss}")
    gmax = max(float(g.norm()) for g in cpu_g.values())
    errs = {}
    for k, g in cpu_g.items():
        errs[k] = float((gpu_g[k].cpu() - g).norm()) / (float(g.norm()) + 1e-3 * gmax)
    worst = max(errs, key=errs.get)
    if errs[worst] > 5e-2 or statistics.median(errs.values()) > 1e-2:
        raise SmokeFailure(f"gradients: {worst} {errs[worst]}, median "
                           f"{statistics.median(errs.values())}")
    losses = {name: [p.train_step(images, caps) for _ in range(2)]
              for name, p in (("cpu", cpu), ("card", card))}
    alpha = keras_alpha(cpu.learning_rate(1), 1)
    cpu_sd, gpu_sd = cpu.state.model.state_dict(), card.state.model.state_dict()
    dev_max, devs = 0.0, []
    for k, t in cpu_sd.items():
        d = (gpu_sd[k].cpu() - t).abs()
        dev_max = max(dev_max, float(d.max()))
        devs.append(d.flatten())
    median_dev = float(torch.cat(devs).median())
    if dev_max > 2.5 * alpha or median_dev > 2e-2 * alpha:
        raise SmokeFailure(f"weights after two steps: max {dev_max}, median {median_dev}, "
                           f"alpha {alpha}")
    say("train_card_vs_cpu", loss_card=gpu_loss, loss_cpu=cpu_loss,
        grad_rel_err_max=errs[worst], grad_rel_err_worst=worst,
        grad_rel_err_median=statistics.median(errs.values()),
        step_losses=losses, alpha=alpha,
        weight_dev_max=dev_max, weight_dev_median=median_dev)


def phase_train_main(fd, fb, torch, Config, Pipeline, tokenizer, workdir) -> dict:
    """(c) ``python -m fpn_mt_image_captioning_torch.train``'s ``main`` on the
    card over a synthetic split of ``TRAIN_MAIN_IMAGES`` training PNGs
    (``write_val_split``'s kind; batches of 10, the tail of 4 padded) and
    ``TRAIN_MAIN_VAL`` validation PNGs, at the flagship's shapes (the
    tokenizer of 2000 words stored first, so the dataset loads it) with the
    fused backbone, for 2 epochs, ``bn_finalize_batches`` 2 and an
    evaluation an epoch. CIDEr is the real ``MetricEval``'s plus the epoch
    number, so that epoch 2 saves a checkpoint. Counters reset just before
    ``main`` and read just after: each decode kernel at the decode steps ×
    its launches a step, ``fused_ir_block`` at 17 × the encodes of the two
    evaluations. The checkpoint the saver wrote restores bitwise to the
    pipeline's final state; the final msgpack file, read through
    ``Pipeline.from_config``, captions the validation pixels as the trained
    pipeline does. Returns the launch counts."""
    import contextlib

    import numpy as np

    from fpn_mt_image_captioning_torch.data.metrics import MetricEval
    from fpn_mt_image_captioning_torch.data.tokenizer import store_tokenizer_to_path
    from fpn_mt_image_captioning_torch.train.__main__ import main as train_main

    root = Path(workdir) / "train_main"
    datadir, _ = write_val_split(root / "data", tokenizer, TRAIN_MAIN_IMAGES, "train2017",
                                 first_id=7000, seed=41)
    _, pixels = write_val_split(root / "data", tokenizer, TRAIN_MAIN_VAL, seed=43)
    store_tokenizer_to_path(tokenizer, root / "tokenizer.json")
    cfg = Config(datadir=datadir, epochs=2, batch_size=10, n_epoch_to_evaluate=1,
                 bn_finalize_batches=2, n_val_dataset=TRAIN_MAIN_VAL, warm_up_steps=TRAIN_WARMUP,
                 fused_backbone=True, tokenizer_filename=str(root / "tokenizer.json"),
                 additional_filename=str(root / "info.json"),
                 transformer_checkpoint_path=str(root / "ckpt"),
                 transformer_weight_path=str(root / "weights.msgpack"),
                 result_dir=str(root / "results"))
    real, epochs = MetricEval.__call__, []

    def scored(self, path):
        epochs.append(real(self, path))
        return epochs[-1] + len(epochs)

    MetricEval.__call__ = scored
    reset_all_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.chdir(root), contextlib.redirect_stdout(io.StringIO()) as printed, \
                contextlib.redirect_stderr(io.StringIO()):   # the progress bars
            pipe = train_main(cfg)
    finally:
        MetricEval.__call__ = real
    wall = time.perf_counter() - t0
    counts = read_all_counts()
    nl = cfg.num_layers
    steps = fd.decoder_logsoftmax_topk.launches
    check_decode_counts(fd, {fd.decoder_linear: 6 * nl + 1, fd.decoder_add_layernorm: 3 * nl,
                             fd.decoder_self_attention: nl, fd.decoder_cross_attention: nl,
                             fd.decoder_logsoftmax_topk: 1}, steps)
    encodes = 2 * -(-TRAIN_MAIN_VAL // cfg.decode_batch)
    if counts["fused_ir_block"] != N_BLOCKS * encodes:
        raise SmokeFailure(f"train main: {counts['fused_ir_block']} backbone launches for "
                           f"{encodes} encodes × {N_BLOCKS}")
    out = printed.getvalue()
    chunks = min(cfg.bn_finalize_batches, TRAIN_MAIN_IMAGES // cfg.batch_size)
    if "Saving checkpoint for epoch 2" not in out or \
            out.count(f"BN stats finalized over {chunks} train batches") != 2:
        raise SmokeFailure(f"train main printed: {out[-2000:]}")
    best = pipe.smart_ckpt_saver.best_saved_step
    if best != 2 or pipe.ckpt_manager.all_steps() != [2]:
        raise SmokeFailure(f"train main: best step {best}, steps {pipe.ckpt_manager.all_steps()}")
    restored, final = pipe.ckpt_manager.restore(pipe.state_tree(), step=best), pipe.state_tree()
    if not trees_equal(restored, final):
        raise SmokeFailure("train main: the checkpoint does not restore bitwise")
    losses = list(pipe.train_loss_history)
    if len(losses) != 2 * -(-TRAIN_MAIN_IMAGES // cfg.batch_size) or \
            not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"train main: losses {losses}")
    order = sorted(pixels)
    images = np.stack([pixels[i] for i in order])
    served = Pipeline.from_config(cfg)
    want, got = pipe.predict_batch(images), served.predict_batch(images)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise SmokeFailure("train main: the weight file captions otherwise than the trained "
                           "pipeline")
    say("train_main", card=card_line(), wall_s=wall, train_steps=len(losses), losses=losses,
        cider=epochs, best_saved_step=best, decode_steps=steps,
        launches={k: n for k, n in counts.items() if k not in PROBE_TPU_KERNELS},
        checkpoint_bitwise=True, from_config_captions_equal=True,
        weights_bytes=os.path.getsize(cfg.transformer_weight_path),
        caption0=pipe.to_caption(want[0][0], want[1][0])[:60])
    return counts


# ---------------------------------------------------------------------------
# phase 16: the ResNet, VGG and DenseNet backbones; the Keras .h5 import
# ---------------------------------------------------------------------------
NEW_BACKBONES = ("resnet50", "resnet101", "resnet152", "vgg16", "vgg19",
                 "densenet121", "densenet169", "densenet201")
CARD_VS_CPU = ("resnet50", "vgg16", "densenet121")   # the smallest depth of each family
BACKBONE_TRAIN = {"resnet50": 5, "vgg16": 5, "densenet121": 5, "resnet152": 1,
                  "densenet201": 1}                   # steps at batch 10
TAPS_BATCH, PREDICT_RUNS, BIG_BATCH = 2, 3, 64
GOLDEN = Path("tests") / "golden"


def seeded_backbone(torch, name: str, dev, seed: int):
    """``name``'s backbone on the card (float32, eval mode): seeded weights
    (``init_weights``; BatchNorm scales 1 + 0.1·N and biases 0.1·N), then
    the statistics calibrated as the CPU tests calibrate theirs: a
    training-mode pass over a seeded batch of 2 at momentum 0 (each running
    mean the batch's, as a trained model's are of its data), each running
    variance raised by U(0.5, 1.5), so that no channel divides by the root of
    a variance near 0."""
    from fpn_mt_image_captioning_torch.models.backbones import backbone
    from fpn_mt_image_captioning_torch.models.layers import BatchNorm32
    from fpn_mt_image_captioning_torch.weights import init_weights

    net = backbone(name).to(dev)
    init_weights(net, torch.Generator(dev).manual_seed(seed))
    g = torch.Generator(dev).manual_seed(seed + 1)
    bns = [m for m in net.modules() if isinstance(m, BatchNorm32)]
    with torch.no_grad():
        for bn in bns:
            bn.weight += 0.1 * torch.randn(bn.weight.shape, generator=g, device=dev)
            bn.bias += 0.1 * torch.randn(bn.bias.shape, generator=g, device=dev)
            bn.momentum = 0.0
        net(torch.rand(2, 3, SIZE, SIZE, generator=g, device=dev) * 2 - 1, train=True)
        for bn in bns:
            bn.momentum = 0.99
            bn.running_var += 0.5 + torch.rand(bn.running_var.shape, generator=g, device=dev)
    return net.eval()


def phase_backbone_taps(torch, dev, name: str, net) -> dict:
    """C3/C4/C5 of ``net`` at 512², batch 2. float32 (TF32 off): for the
    smallest depth of each family, the card's taps against the CPU route's
    on the same weights, every element within atol 2e-4 + rtol 1e-3.
    bfloat16 (convs in bf16, BatchNorm in float32, as served): roundings
    cascade through up to 50 ResNet blocks and 98 DenseNet layers, so, as
    phase 5 holds the fused backbone, the taps may stray from the float32
    ones no further (relative L2) than another bf16 route does — the same
    module on ``channels_last`` tensors, which cuDNN runs with other
    kernels — with a 25 % margin + 1e-3."""
    from fpn_mt_image_captioning_torch.decode.beam_search import cast_for_inference

    g = torch.Generator(dev).manual_seed(77)
    x = torch.rand(TAPS_BATCH, 3, SIZE, SIZE, generator=g, device=dev) * 2 - 1
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()
    line = {}
    with torch.no_grad():
        f32 = net(x)
        if name in CARD_VS_CPU:
            t0 = time.perf_counter()
            want = copy.deepcopy(net).cpu()(x.cpu())
            line["cpu_s"] = time.perf_counter() - t0
            for tap, a, b in zip(("C3", "C4", "C5"), f32, want):
                line[f"{tap}_card_vs_cpu_max_abs_err"] = close(
                    f"{name} {tap} float32 card vs CPU", a.cpu(), b, atol=2e-4, rtol=1e-3)
        bf = cast_for_inference(copy.deepcopy(net), torch.bfloat16)
        nchw = bf(x.bfloat16())
        bf = bf.to(memory_format=torch.channels_last)
        cl = bf(x.bfloat16().contiguous(memory_format=torch.channels_last))
    for tap, a, b, c in zip(("C3", "C4", "C5"), nchw, cl, f32):
        r, r_cl = rel(a, c), rel(b, c)
        if not bool(a.isfinite().all()) or r > 1.25 * r_cl + 1e-3:
            raise SmokeFailure(f"{name} {tap} bfloat16: {r} from float32 (channels_last {r_cl})")
        line[f"{tap}_bf16_vs_f32"], line[f"{tap}_bf16_channels_last_vs_f32"] = r, r_cl
    line["shapes"] = [list(t.shape) for t in f32]
    return line


def backbone_tree(net, base: dict) -> dict:
    """The flagship's variables ``base`` (JAX layout) with ``net`` as the
    backbone and the FPN's C3/C4/C5 laterals at its tap widths (seeded
    he-normal 1×1 kernels, biases 0.1·N); every other leaf is ``base``'s."""
    import numpy as np

    from fpn_mt_image_captioning_torch.weights import to_flax

    bb = to_flax(net)
    rng = np.random.default_rng(sum(net.tap_channels))
    params = dict(base["params"])
    enc = params["encoder"] = dict(params["encoder"])
    fe = enc["feature_extractor"] = dict(enc["feature_extractor"])
    fpn = fe["fpn"] = dict(fe["fpn"])
    fe["backbone"] = bb["params"]
    for tap, c in zip(("C3", "C4", "C5"), net.tap_channels):
        fpn[f"{tap}_reduced"] = {
            "kernel": rng.standard_normal((1, 1, c, 256), np.float32) * np.float32(
                math.sqrt(2.0 / c)),
            "bias": 0.1 * rng.standard_normal(256, np.float32)}
    stats = {"encoder": {"feature_extractor": {"backbone": bb["batch_stats"]}}} \
        if bb["batch_stats"] else {}
    return {"params": params, "batch_stats": stats}


def phase_backbone_predict(fd, torch, dev, Config, Pipeline, tokenizer, name, tree) -> dict:
    """``predict_batch`` at batch 64, bf16, the flagship's widths with
    ``name`` as the backbone and ``fused_backbone=True``, which encodes
    eagerly for a backbone that is not MobileNetV2 (no packed backbone):
    a warm-up, then counters reset and ``PREDICT_RUNS`` timed runs (median
    wall), every decode kernel at the decode steps × its launches a step,
    ``fused_ir_block`` at 0; then as many timed encodes. Peak allocated
    memory over the timed runs."""
    import numpy as np

    cfg = Config(backbone=name, beam_search_n=BEAM, compute_dtype="bfloat16", decode_batch=B,
                 fused_backbone=True)
    pipe = Pipeline(tokenizer, MAX_LEN, cfg, tree, device=dev)
    if pipe.backbone_packed is not None:
        raise SmokeFailure(f"{name}: fused_backbone=True packed a backbone it cannot fuse")
    images = np.random.default_rng(2024).integers(0, 256, (B, SIZE, SIZE, 3), dtype=np.uint8)
    pipe.predict_batch(images)                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    walls, encodes = [], []
    for _ in range(PREDICT_RUNS):
        t0 = time.perf_counter()
        seqs, lengths = pipe.predict_batch(images)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    counts = read_all_counts()
    steps = fd.decoder_logsoftmax_topk.launches
    check_decode_counts(fd, decode_per_step(fd), steps)
    if counts["fused_ir_block"] != 0:
        raise SmokeFailure(f"{name}: fused_ir_block launched {counts['fused_ir_block']} times")
    seqs_in_range(name, seqs, lengths, B)
    for _ in range(PREDICT_RUNS):
        t0 = time.perf_counter()
        pipe.encode(images)
        torch.cuda.synchronize()
        encodes.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    wall = statistics.median(walls)
    del pipe
    torch.cuda.empty_cache()
    return dict(wall_s=wall, wall_s_runs=walls, images_per_s=B / wall,
                encode_s=statistics.median(encodes), encode_s_runs=encodes,
                decode_steps=steps, max_memory_allocated_bytes=peak,
                caption_tokens0=seqs[0][:lengths[0]].tolist()[:12]), counts


def phase_backbones(fd, torch, dev, Config, Pipeline, tokenizer, base) -> tuple[dict, dict]:
    """(a) The eight new backbones at the flagship's widths: taps
    (``phase_backbone_taps``) and ``predict_batch`` (``phase_backbone_predict``)
    of each. Returns each backbone's variables (for (b)) and the launch
    counts summed over the eight counted runs."""
    trees, totals = {}, {}
    for i, name in enumerate(NEW_BACKBONES):
        t0 = time.perf_counter()
        net = seeded_backbone(torch, name, dev, seed=100 + i)
        taps = phase_backbone_taps(torch, dev, name, net)
        trees[name] = backbone_tree(net, base)
        del net
        predict, counts = phase_backbone_predict(fd, torch, dev, Config, Pipeline, tokenizer,
                                                 name, trees[name])
        for k, n in counts.items():
            totals[k] = totals.get(k, 0) + n
        say(f"backbone_{name}", card=card_line(), seconds=time.perf_counter() - t0,
            taps=taps, predict_batch64=predict,
            launches={k: n for k, n in counts.items() if k not in PROBE_TPU_KERNELS})
    return trees, totals


def phase_backbones_train(torch, dev, Config, Pipeline, tokenizer, trees, workdir) -> None:
    """(b) ``train_step`` at the flagship's widths (bf16 compute, float32
    master weights, dropout 0.1) on one fixed seeded batch of 10: ResNet-50,
    VGG16 and DenseNet-121 five steps each (every loss finite, the last
    below the first; median step wall, images/s, peak allocated memory, the
    idle share over a traced step), ResNet-152 and DenseNet-201 one step
    (its peak memory). Then batch 64, reckoned first: the peak at 64 is
    predicted as the batch-10 peak's part that grows with the batch, × 6.4,
    beside what does not (float32 weights, gradients and three Adam
    moments, the bf16 served copy: 22 bytes a parameter); one step at 64 is
    run where the prediction is below 90 % of the card's memory."""
    import numpy as np

    total = torch.cuda.get_device_properties(dev).total_memory
    images, caps = train_batch(np.random.default_rng(10), 10, MAX_LEN)
    big = train_batch(np.random.default_rng(64), BIG_BATCH, MAX_LEN)
    for name, n_steps in BACKBONE_TRAIN.items():
        t0 = time.perf_counter()
        cfg = Config(backbone=name, batch_size=10, warm_up_steps=TRAIN_WARMUP)
        pipe = Pipeline(tokenizer, MAX_LEN, cfg, trees[name], device=dev,
                        checkpoint_path=str(Path(workdir) / f"train_{name}"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, walls = [], []
        for _ in range(n_steps):
            t1 = time.perf_counter()
            losses.append(pipe.train_step(images, caps))   # reads the loss back: synchronised
            walls.append(time.perf_counter() - t1)
        peak = torch.cuda.max_memory_allocated()
        if not all(math.isfinite(x) for x in losses):
            raise SmokeFailure(f"train {name}: losses {losses}")
        line = dict(steps=n_steps, losses=losses, step_s_runs=walls,
                    max_memory_allocated_bytes=peak)
        if n_steps > 1:
            if not losses[-1] < losses[0]:
                raise SmokeFailure(f"train {name}: the loss does not fall: {losses}")
            wall = statistics.median(walls)
            trace = profile_run(torch, lambda: pipe.train_step(images, caps))
            line.update(step_s=wall, images_per_s=10 / wall, trace_wall_ms=trace["wall_ms"],
                        device_busy_ms=trace["device_busy_ms"],
                        device_idle_share=trace["device_idle_share"], trace_top=trace["top"][:5])
        n_params = sum(p.numel() for p in pipe.state.model.parameters())
        fixed = 22 * n_params
        predicted = fixed + (peak - fixed) * BIG_BATCH / 10
        line.update(parameters=n_params, predicted_batch64_bytes=predicted,
                    card_memory_bytes=total)
        if predicted < 0.9 * total:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            loss64 = pipe.train_step(*big)
            line.update(batch64_step_s=time.perf_counter() - t1, batch64_loss=loss64,
                        batch64_max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
            if not math.isfinite(loss64):
                raise SmokeFailure(f"train {name} batch 64: loss {loss64}")
        line["seconds"] = time.perf_counter() - t0
        del pipe
        torch.cuda.empty_cache()
        say(f"train_{name}", card=card_line(), batch=10, warm_up_steps=TRAIN_WARMUP, **line)


def phase_h5_import(torch, dev, Config, Pipeline, tokenizer, base, workdir) -> list:
    """(c) The Keras ``.h5`` import, with no ``h5py`` in play: the golden
    Keras MobileNetV2 file (alpha 0.35) read by the port's own reader and
    imported into a backbone on the card, whose float32 C3/C4/C5 must hold
    Keras' own activations (``mobilenet_v2_a035_golden.npz``) at the JAX
    package's bar, atol 2e-4 + rtol 1e-3; the ``train`` main booted from the
    file (``retinanet_weight_path``, mobilenet224_0.35 at the flagship's
    other widths) for 2 steps, printing the import's report, every loss
    finite; and a Keras-named in-memory dict of the flagship's backbone, FPN
    and head trunks imported into a flagship whose those parts were seeded
    otherwise: the weights then equal the source's, bitwise, and so does
    the float32 encode of 8 images. Returns the golden file's taps."""
    import contextlib
    import importlib.util

    import numpy as np

    from fpn_mt_image_captioning_torch.data.tokenizer import store_tokenizer_to_path
    from fpn_mt_image_captioning_torch.train.__main__ import main as train_main
    from fpn_mt_image_captioning_torch.utils.weight_import import (load_keras_h5,
                                                                   retinanet_keras_layers)

    repo = Path(__file__).resolve().parent
    h5 = repo / GOLDEN / "mobilenet_v2_a035.h5"
    t0 = time.perf_counter()
    layers = load_keras_h5(h5)
    read_s = time.perf_counter() - t0
    taps, report, errs = golden_taps(torch, dev, layers)
    root = Path(workdir) / "h5_boot"
    datadir, _ = write_val_split(root / "data", tokenizer, 20, "train2017", first_id=7000,
                                 seed=51)
    write_val_split(root / "data", tokenizer, 2, seed=53)
    store_tokenizer_to_path(tokenizer, root / "tokenizer.json")
    cfg = Config(datadir=datadir, epochs=1, batch_size=10, n_epoch_to_evaluate=2,
                 n_val_dataset=2, warm_up_steps=TRAIN_WARMUP, backbone="mobilenet224_0.35",
                 retinanet_weight_path=str(h5), tokenizer_filename=str(root / "tokenizer.json"),
                 additional_filename=str(root / "info.json"),
                 transformer_checkpoint_path=str(root / "ckpt"),
                 transformer_weight_path=str(root / "weights.msgpack"),
                 result_dir=str(root / "results"))
    t0 = time.perf_counter()
    with contextlib.chdir(root), contextlib.redirect_stdout(io.StringIO()) as printed, \
            contextlib.redirect_stderr(io.StringIO()):
        trained = train_main(cfg)
    main_s = time.perf_counter() - t0
    line = f"Loaded pretrained retinanet weights: {report!r}"
    losses = list(trained.train_loss_history)
    if line not in printed.getvalue():
        raise SmokeFailure("the train main did not boot from the .h5: "
                           f"{printed.getvalue()[-1500:]}")
    if len(losses) != 2 or not all(math.isfinite(x) for x in losses):
        raise SmokeFailure(f"the train main from the .h5: losses {losses}")
    del trained

    rng = np.random.default_rng(61)
    source = base
    reached = ("backbone", "fpn", "regression_trunk", "classification_trunk")

    def reseeded(tree):
        return {k: reseeded(v) if isinstance(v, dict) else
                rng.standard_normal(v.shape, np.float32) * np.float32(0.05)
                for k, v in tree.items()}

    target = {c: dict(source[c]) for c in source}
    for c in target:
        enc = target[c]["encoder"] = dict(target[c]["encoder"])
        fe_t = enc["feature_extractor"] = dict(enc["feature_extractor"])
        for part in reached:
            if part in fe_t:
                fe_t[part] = reseeded(fe_t[part])
    cfg32 = Config(compute_dtype="float32")
    want = Pipeline(tokenizer, MAX_LEN, cfg32, source, device=dev)
    pipe = Pipeline(tokenizer, MAX_LEN, cfg32, target, device=dev)
    flagship_report = pipe.load_pretrained_retinanet(retinanet_keras_layers(source))
    if flagship_report.missed:
        raise SmokeFailure(f"flagship import missed {flagship_report.missed[:5]}")
    got_sd, want_sd = pipe.transformer.state_dict(), want.transformer.state_dict()
    if any(not torch.equal(got_sd[k], t) for k, t in want_sd.items()):
        raise SmokeFailure("the imported flagship's weights differ from the source's")
    pixels = np.random.default_rng(62).integers(0, 256, (8, SIZE, SIZE, 3), dtype=np.uint8)
    encode_err = (pipe.encode(pixels) - want.encode(pixels)).abs().max().item()
    if encode_err != 0.0:
        raise SmokeFailure(f"the imported flagship's encode differs by {encode_err}")
    del pipe, want
    torch.cuda.empty_cache()
    say("h5_import", card=card_line(), h5py_importable=importlib.util.find_spec("h5py")
        is not None, golden_read_s=read_s, golden_layers=len(layers),
        golden_report=repr(report), golden_max_abs_err=errs, train_main_s=main_s,
        train_main_losses=losses, flagship_report=repr(flagship_report),
        flagship_weights_bitwise=True, flagship_encode_max_abs_err=encode_err)
    return taps


def golden_taps(torch, dev, layers) -> tuple[list, object, dict]:
    """The golden Keras file's ``layers`` imported into a MobileNetV2
    backbone (alpha 0.35) on the card: its float32 C3/C4/C5 of the golden
    input (held to Keras' own activations, atol 2e-4 + rtol 1e-3), the
    import's report and the errors."""
    import numpy as np

    from fpn_mt_image_captioning_torch.models.backbones.mobilenet_v2 import MobileNetV2Backbone
    from fpn_mt_image_captioning_torch.utils.weight_import import import_retinanet_weights
    from fpn_mt_image_captioning_torch.weights import from_flax, to_flax

    golden = np.load(Path(__file__).resolve().parent / GOLDEN / "mobilenet_v2_a035_golden.npz")
    net = MobileNetV2Backbone(alpha=float(golden["alpha"]))
    bb = to_flax(net)
    wrap = lambda t: {"encoder": {"feature_extractor": {"backbone": t, "fpn": {}}}}
    imported, report = import_retinanet_weights(
        {"params": wrap(bb["params"]), "batch_stats": wrap(bb["batch_stats"])}, layers)
    fe = {c: imported[c]["encoder"]["feature_extractor"]["backbone"] for c in imported}
    net.load_state_dict(from_flax(fe), strict=True)
    net = net.to(dev).eval()
    with torch.no_grad():
        taps = [t.cpu() for t in net(torch.as_tensor(golden["x"], device=dev)
                                     .permute(0, 3, 1, 2))]
    errs = {}
    for tap, t in zip(("C3", "C4", "C5"), taps):
        errs[tap] = close(f"golden .h5 {tap}", t.permute(0, 2, 3, 1),
                          torch.as_tensor(golden[tap]), atol=2e-4, rtol=1e-3)
    return taps, report, errs


def phase_16(fd, torch, dev, Config, Pipeline, tokenizer, base, workdir) -> dict:
    t0 = time.perf_counter()
    trees, counts = phase_backbones(fd, torch, dev, Config, Pipeline, tokenizer, base)
    phase_backbones_train(torch, dev, Config, Pipeline, tokenizer, trees, workdir)
    del trees
    taps = phase_h5_import(torch, dev, Config, Pipeline, tokenizer, base, workdir)
    say("phase16", seconds=time.perf_counter() - t0)
    return counts, taps


# ---------------------------------------------------------------------------
# phase 17: the serving artifact
# ---------------------------------------------------------------------------
ART_BATCH, ART_REQUEST, ART_SEED = 16, 61, 7   # decode_batch's default; 4 chunks, the last padded
ART_TRAIN_LAYERS, ART_SAMPLE_LAYERS, ART_SAMPLE_LEN = 2, 1, 16
SUBPROCESS_CAPTIONS = r"""
import json, sys
import numpy as np
from fpn_mt_image_captioning_torch.export import load_serving
served = load_serving(sys.argv[1])
captions = served.caption(np.load(sys.argv[2]))
print(json.dumps({"captions": captions, "load_seconds": served.load_seconds,
                  "transformer_imported":
                      "fpn_mt_image_captioning_torch.models.transformer" in sys.modules}))
"""


def card_normalized(torch, images, dev):
    """uint8 images normalized on the host to the values the device's own
    normalize gives each of the 256 bytes (looked up): a CUDA division by a
    scalar multiplies by the scalar's float32 reciprocal, an ulp away from
    x / 127.5 at 111 of the 256 values."""
    from fpn_mt_image_captioning_torch.models.layers import normalize_images

    table = normalize_images(torch.arange(256, dtype=torch.uint8, device=dev)).cpu().numpy()
    return table[images]


def equal_outputs(name, got, want) -> None:
    import numpy as np

    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        bad = int((np.asarray(got[1]) != np.asarray(want[1])).sum())
        raise SmokeFailure(f"{name}: tokens or lengths differ ({bad} lengths differ)")


def artifact_counts(fd, chunks: int, backbone_blocks: int) -> dict:
    """Check the launches of an artifact's beam run: each decode kernel at
    ``MAX_LEN`` steps × ``chunks`` × its launches a step, the fused backbone
    kernel at ``backbone_blocks`` × ``chunks``; the counts."""
    counts = read_all_counts()
    check_decode_counts(fd, decode_per_step(fd), MAX_LEN * chunks)
    if counts["fused_ir_block"] != backbone_blocks * chunks:
        raise SmokeFailure(f"artifact: {counts['fused_ir_block']} backbone launches for "
                           f"{chunks} chunks × {backbone_blocks}")
    return counts


def check_graph(fd, meta: dict, fname: str) -> None:
    """The beam program holds each decode kernel's operator at MAX_LEN × its
    launches a step."""
    from fpn_mt_image_captioning_torch.ops.operators import OP_NAMES

    want = {OP_NAMES[k]: MAX_LEN * n for k, n in decode_per_step(fd).items()}
    got = {k: v for k, v in meta["programs"][fname]["kernel_nodes"].items() if k in want.keys()}
    if got != want:
        raise SmokeFailure(f"{fname}: kernel nodes {got}, expected {want}")


def phase_artifact_turns(torch, fd, served, pipe, rng) -> dict:
    """``ExportedServing.predict_batch`` against ``Pipeline.predict_batch`` at
    16 and 64 images in turns (pipeline, artifact, artifact, pipeline, five
    times; medians), with the decode steps of each call (the pipeline's
    from its spans, as it replays graphs; the artifact's from the counters)."""
    import numpy as np

    out = {}
    for n in (16, 64):
        images = rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
        served.predict_batch(images)
        pipe.predict_batch(images)
        turns, steps = {"pipeline": [], "artifact": []}, {"pipeline": [], "artifact": []}
        ran = {"pipeline": decode_steps, "artifact": lambda: fd.decoder_logsoftmax_topk.launches}
        for _ in range(5):
            for name, p in (("pipeline", pipe), ("artifact", served), ("artifact", served),
                            ("pipeline", pipe)):
                start = ran[name]()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p.predict_batch(images)
                torch.cuda.synchronize()
                turns[name].append(time.perf_counter() - t0)
                steps[name].append((ran[name]() - start) // -(-n // ART_BATCH))
        out[n] = {"pipeline_s": statistics.median(turns["pipeline"]),
                  "artifact_s": statistics.median(turns["artifact"]), "runs": turns,
                  "steps_per_chunk": {k: sorted(set(v)) for k, v in steps.items()}}
        if set(steps["artifact"]) != {MAX_LEN}:
            raise SmokeFailure(f"artifact: decode steps {steps['artifact']}, not {MAX_LEN}")
    return out


def traced_copies(torch, fn) -> dict:
    """One traced run of ``fn``: wall, device busy ms and idle share, and the
    device ms and launches of copy kernels (memcpy, ``copy_`` and cat)."""
    from fpn_mt_image_captioning_torch.utils.profiling import cuda_kernel_times

    rows, wall_ms = cuda_kernel_times(fn)
    busy = sum(us for _, us, _ in rows) / 1e3
    copies = [(k, us, c) for k, us, c in rows
              if any(w in k.lower() for w in ("copy", "memcpy", "cat"))]
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "device_idle_share": 1 - busy / wall_ms,
            "copy_ms": sum(us for _, us, _ in copies) / 1e3,
            "copy_kernels": [{"kernel": k[:90], "ms": us / 1e3, "count": c}
                             for k, us, c in sorted(copies, key=lambda r: -r[1])[:6]]}


def program_stats(meta: dict, served) -> dict:
    """Each program's export seconds, nodes and bytes, with its load
    seconds where it has loaded."""
    return {k: {**v, "load_s": served.load_seconds.get(k)} for k, v in meta["programs"].items()}


def phase_artifact_main(fd, torch, build, workdir) -> dict:
    """(a), (c), (d) at the flagship, on its beam programs: export and
    load; a request of 61 images bitwise equal to the pipeline's with the
    launches counted; the float program against the uint8 one; a fresh
    process that captions without the model module; the CLI and the server
    on the artifact; the in-turns times and a traced run. Each step prints
    its line as it ends. Returns the launches of the request."""
    import numpy as np

    from fpn_mt_image_captioning_torch import caption, serve
    from fpn_mt_image_captioning_torch import export as ex

    card = card_line()
    pipe = build(decode_batch=ART_BATCH, max_decode_rows=ART_BATCH * BEAM)
    art = Path(workdir) / "artifact"
    reset_all_counts()
    t0 = time.perf_counter()
    meta = ex.export_serving(pipe, str(art))
    export_s = time.perf_counter() - t0
    if any(read_all_counts().values()):
        raise SmokeFailure("export launched a kernel (it traces on fake tensors)")
    check_graph(fd, meta, ex.ARTIFACT_FN)
    check_graph(fd, meta, ex.ARTIFACT_U8_FN)
    say("artifact_export", card=card, export_s=export_s, programs=meta["programs"],
        weights_bytes=os.path.getsize(art / ex.ARTIFACT_WEIGHTS))

    # (a) a request of four chunks, the last padded
    t0 = time.perf_counter()
    served = ex.load_serving(str(art))
    open_s = time.perf_counter() - t0
    rng = np.random.default_rng(1717)
    images = rng.integers(0, 256, (ART_REQUEST, SIZE, SIZE, 3), dtype=np.uint8)
    chunks = -(-ART_REQUEST // ART_BATCH)
    want = pipe.predict_batch(images)
    reset_all_counts()
    got = served.predict_batch(images)
    counts = artifact_counts(fd, chunks, 0)
    equal_outputs("artifact uint8 vs Pipeline.predict_batch", got, want)
    captions = [served.to_caption(s, n) for s, n in zip(*got)]
    if captions != [pipe.to_caption(s, n) for s, n in zip(*want)]:
        raise SmokeFailure("artifact: captions differ from the pipeline's")
    equal_outputs("artifact float vs uint8", served.predict_batch(
        card_normalized(torch, images, pipe.device)), got)
    say("artifact_request", card=card, open_s=open_s, programs=program_stats(meta, served),
        request=ART_REQUEST, chunks=chunks, bitwise_equal_to_pipeline=True,
        float_equal_uint8=True, caption0=captions[0][:60],
        launches={k: n for k, n in counts.items() if k not in PROBE_TPU_KERNELS})

    # (c) a fresh process: the captions, without the model module
    chunk = images[:ART_BATCH]
    np.save(art.parent / "request.npy", chunk)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", SUBPROCESS_CAPTIONS, str(art),
                           str(art.parent / "request.npy")], capture_output=True, text=True,
                          timeout=900, cwd=Path(__file__).resolve().parent)
    if proc.returncode != 0:
        raise SmokeFailure(f"artifact subprocess failed: {proc.stderr[-3000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    if fresh["transformer_imported"] or fresh["captions"] != captions[:ART_BATCH]:
        raise SmokeFailure(f"artifact subprocess: {fresh}")
    say("artifact_subprocess", card=card, wall_s=time.perf_counter() - t0,
        load_seconds=fresh["load_seconds"], transformer_imported=False, captions_equal=True)

    # (d) the CLI and the server on the artifact
    img_dir = art.parent / "artifact_images"
    img_dir.mkdir()
    for i, a in enumerate(images[:20]):
        (img_dir / f"img{i:03d}.png").write_bytes(png_bytes(a))
    cfg = served.apply_to_config(pipe.config)
    results = caption.main(cfg, str(img_dir), str(art.parent / "cli.json"), pipeline=served)
    if [r["caption"] for r in results] != captions[:20]:
        raise SmokeFailure("artifact CLI: captions differ from predict_batch's")
    srv = serve.make_server(cfg, port=0, max_delay_ms=200.0, pipeline=served)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(i):
        req = urllib.request.Request(base + "/caption", method="POST",
                                     data=(img_dir / f"img{i:03d}.png").read_bytes())
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())["caption"]

    try:
        with ThreadPoolExecutor(SERVER_REQUESTS) as pool:
            replies = list(pool.map(post, range(SERVER_REQUESTS)))
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        thread.join(timeout=60)
    if replies != [(200, c) for c in captions[:SERVER_REQUESTS]]:
        raise SmokeFailure(f"artifact server: {replies}")
    say("artifact_cli_server", card=card, cli_files=len(results), server_requests=len(replies),
        equal_to_predict_batch=True)

    turns = phase_artifact_turns(torch, fd, served, pipe, rng)
    say("artifact_in_turns", card=card, batch16=turns[16], batch64=turns[64])
    say("artifact_trace", card=card, batch=ART_BATCH,
        artifact=traced_copies(torch, lambda: served.predict_batch(chunk)),
        pipeline=traced_copies(torch, lambda: pipe.predict_batch(chunk)))
    return counts


def phase_artifact_sampling(torch, build, workdir) -> None:
    """(b) the four sampling programs, exported from the flagship's widths cut
    in depth to ``ART_SAMPLE_LAYERS``+``ART_SAMPLE_LAYERS`` layers and
    ``ART_SAMPLE_LEN`` steps (a program inlines the non-fused step once a
    layer and a step, and its export and load take ~3 ms of host a node):
    uint8 and float, with and without ``top_p``, each equal to
    ``Pipeline.sample_batch`` on a full chunk."""
    import numpy as np

    from fpn_mt_image_captioning_torch import export as ex

    pipe = build(num_layers=ART_SAMPLE_LAYERS, max_len=ART_SAMPLE_LEN, decode_batch=ART_BATCH,
                 max_decode_rows=ART_BATCH * BEAM)
    art = Path(workdir) / "artifact_sampling"
    t0 = time.perf_counter()
    meta = ex.export_serving(pipe, str(art), sample=True)
    export_s = time.perf_counter() - t0
    say("artifact_sampling_export", card=card_line(), layers=ART_SAMPLE_LAYERS,
        steps=ART_SAMPLE_LEN, export_s=export_s, programs=meta["programs"])
    served = ex.load_serving(str(art))
    chunk = np.random.default_rng(1720).integers(0, 256, (ART_BATCH, SIZE, SIZE, 3),
                                                 dtype=np.uint8)
    temps = np.linspace(0.5, 1.2, ART_BATCH).astype(np.float32)
    for top_p in (0.9, None):
        want = pipe.sample_batch(chunk, seed=ART_SEED, temperature=temps, top_p=top_p)
        for x in (chunk, card_normalized(torch, chunk, pipe.device)):
            equal_outputs(f"sampling top_p={top_p} {x.dtype}", served.sample_batch(
                x, seed=ART_SEED, temperature=temps, top_p=top_p), want)
    say("artifact_sampling", card=card_line(), layers=ART_SAMPLE_LAYERS,
        load_s=served.load_seconds, sampling_equal_to_pipeline=True, lengths=want[1].tolist())


def phase_artifact_train(fd, torch, Config, workdir) -> None:
    """(e, f) the ``train`` main over phase 15's corpus at 2+2 layers with
    the fused backbone (as phase 15 trains) for 2 steps with ``profile_dir``
    and ``export_artifact_dir``: the trace holds CUDA kernel events; the
    artifact it exports is a fused-backbone one with beam programs only,
    and loads and equals the trained pipeline's ``predict_batch`` on a
    request of two chunks, each decode kernel at max_seq_len (the corpus')
    × 2 × its launches a step and ``fused_ir_block`` at 17 a chunk."""
    import contextlib
    import glob

    import numpy as np

    from fpn_mt_image_captioning_torch import export as ex
    from fpn_mt_image_captioning_torch.train.__main__ import main as train_main

    root = Path(workdir) / "train_main"
    out = Path(workdir) / "artifact_train"
    cfg = Config(datadir=str(root / "data"), epochs=1, batch_size=10, fused_backbone=True,
                 n_train_dataset=2 * 10, n_epoch_to_evaluate=100, num_layers=ART_TRAIN_LAYERS,
                 warm_up_steps=TRAIN_WARMUP, tokenizer_filename=str(root / "tokenizer.json"),
                 additional_filename=str(out / "info.json"),
                 transformer_checkpoint_path=str(out / "ckpt"),
                 transformer_weight_path=str(out / "weights.msgpack"),
                 result_dir=str(out / "results"), profile_dir=str(out / "profile"),
                 export_artifact_dir=str(out / "artifact"))
    t0 = time.perf_counter()
    with contextlib.chdir(root), contextlib.redirect_stdout(io.StringIO()) as printed, \
            contextlib.redirect_stderr(io.StringIO()):
        pipe = train_main(cfg)
    wall = time.perf_counter() - t0
    traces = glob.glob(str(out / "profile" / "*.pt.trace.json"))
    if len(pipe.train_loss_history) != 2 or len(traces) != 1:
        raise SmokeFailure(f"train main: steps {pipe.train_loss_history}, traces {traces}")
    events = json.loads(Path(traces[0]).read_text())["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    if kernels == 0:
        raise SmokeFailure("train main: the trace holds no CUDA kernel event")
    if not (out / "artifact" / ex.ARTIFACT_META).is_file():
        raise SmokeFailure(f"train main: no artifact; it printed {printed.getvalue()[-2000:]}")
    served = ex.load_serving(str(out / "artifact"))
    meta = served.meta
    if not meta["fused_backbone"] or meta["sampling"] or \
            meta["programs"][ex.ARTIFACT_U8_FN]["kernel_nodes"]["fpn_mt::fused_ir_block"] \
            != N_BLOCKS:
        raise SmokeFailure(f"train main's artifact: {meta}")
    images = np.random.default_rng(1719).integers(0, 256, (2 * ART_BATCH, SIZE, SIZE, 3),
                                                  dtype=np.uint8)
    want = pipe.predict_batch(images[:ART_BATCH]), pipe.predict_batch(images[ART_BATCH:])
    reset_all_counts()
    got = served.predict_batch(images)
    counts = read_all_counts()
    nl = ART_TRAIN_LAYERS
    check_decode_counts(fd, {fd.decoder_linear: 6 * nl + 1, fd.decoder_add_layernorm: 3 * nl,
                             fd.decoder_self_attention: nl, fd.decoder_cross_attention: nl,
                             fd.decoder_logsoftmax_topk: 1}, meta["max_seq_len"] * 2)
    if counts["fused_ir_block"] != N_BLOCKS * 2:
        raise SmokeFailure(f"train main's artifact: {counts['fused_ir_block']} backbone "
                           "launches for 2 chunks")
    equal_outputs("trained fused artifact vs the trained pipeline", got,
                  tuple(np.concatenate(parts) for parts in zip(*want)))
    say("artifact_train_main", card=card_line(), wall_s=wall, layers=ART_TRAIN_LAYERS,
        steps=2, losses=pipe.train_loss_history, trace_file_bytes=os.path.getsize(traces[0]),
        trace_kernel_events=kernels, programs=program_stats(meta, served),
        weights_bytes=os.path.getsize(out / "artifact" / ex.ARTIFACT_WEIGHTS),
        bitwise_equal_to_pipeline=True,
        launches={k: n for k, n in counts.items() if k not in PROBE_TPU_KERNELS})


def phase_17(fd, torch, build, Config, workdir) -> dict:
    t0 = time.perf_counter()
    counts = phase_artifact_main(fd, torch, build, workdir)
    torch.cuda.empty_cache()
    phase_artifact_sampling(torch, build, workdir)
    torch.cuda.empty_cache()
    phase_artifact_train(fd, torch, Config, workdir)
    say("phase17", card=card_line(), seconds=time.perf_counter() - t0)
    return counts


# ---------------------------------------------------------------------------
# phase 18: several ranks
# ---------------------------------------------------------------------------
P18_BATCH, P18_STEPS, P18_MESHES, P18_TIMEOUT = 16, 3, ((2, 1), (1, 2)), 170
P18_MAIN_LAYERS, P18_ONE_BATCH = 2, 4


def p18_batch():
    import numpy as np

    return train_batch(np.random.default_rng(1800), P18_BATCH, MAX_LEN)


def p18_predict_images():
    import numpy as np

    return np.random.default_rng(1801).integers(0, 256, (P18_BATCH, SIZE, SIZE, 3),
                                                dtype=np.uint8)


def p18_train_config(Config, MeshConfig, mesh=None):
    """The flagship in float32 at a global batch of 16 (dropout 0.1, the
    default warm-up); ``mesh``: (data, model) or None."""
    enabled = mesh is not None
    data, model = mesh or (-1, 1)
    return Config(batch_size=P18_BATCH, compute_dtype="float32",
                  mesh=MeshConfig(enabled=enabled, data_axis_size=data, model_axis_size=model))


def p18_reference(torch, dev, Config, Pipeline, tokenizer, workdir) -> dict:
    """One process on the card: ``P18_STEPS`` flagship steps on the global
    batch (the reference of (a): losses, weights, BatchNorm statistics,
    Adam's first moments, written for the ranks), and ``predict_batch`` of
    each rank's 8 images at beam 8, bf16 (the reference of (b))."""
    import numpy as np

    from fpn_mt_image_captioning_torch.config import MeshConfig
    from fpn_mt_image_captioning_torch.models.layers import BatchNorm32

    images, caps = p18_batch()
    pipe = Pipeline(tokenizer, MAX_LEN, p18_train_config(Config, MeshConfig), seed=0, device=dev,
                    checkpoint_path=str(Path(workdir) / "p18_reference"))
    walls, losses = [], []
    for _ in range(P18_STEPS):
        t0 = time.perf_counter()
        losses.append(pipe.train_step(images, caps))
        walls.append(time.perf_counter() - t0)
    model = pipe.state.model
    torch.save({"losses": losses,
                "params": {n: p.detach().cpu() for n, p in model.named_parameters()},
                "stats": {n: b.cpu() for n, b in model.named_buffers()},
                "m": [t.cpu() for t in pipe.state.opt_state.m]},
               Path(workdir) / "p18_reference.pt")
    del pipe, model
    served = Pipeline(tokenizer, MAX_LEN, Config(beam_search_n=BEAM, compute_dtype="bfloat16",
                                                 decode_batch=P18_BATCH), seed=0, device=dev)
    pimgs = p18_predict_images()
    half = P18_BATCH // 2
    parts = [served.predict_batch(pimgs[:half]), served.predict_batch(pimgs[half:])]
    np.savez(Path(workdir) / "p18_reference.npz", seqs=np.concatenate([p[0] for p in parts]),
             lengths=np.concatenate([p[1] for p in parts]))
    del served
    torch.cuda.empty_cache()
    return {"step_s": statistics.median(walls), "step_s_runs": walls, "losses": losses}


def p18_compare_step(torch, pipe, ref: dict) -> dict:
    """(a)'s bar, the JAX test's (tests/test_parallel.py:141-145): the
    loss of every step within rtol 1e-5, every weight within atol 2e-5; the
    BatchNorm statistics within rtol 1e-5, atol 1e-6; Adam's first moments
    per tensor within 5e-2·(‖ref‖ + 1e-3·max‖ref‖), median 1e-2 (phase 15's
    bar between float32 gradients on the card and the CPU: training-mode
    BatchNorm makes them that ill-conditioned, and the ranks sum the
    moments in another order). Collective: every rank calls it; the whole
    weights are compared on rank 0."""
    from fpn_mt_image_captioning_torch.parallel.multihost import rank
    from fpn_mt_image_captioning_torch.parallel.train import whole_state_dict

    whole = whole_state_dict(pipe.state.model)
    m = pipe._whole(pipe.state.opt_state.m)
    if rank() != 0:
        return {}
    for got, want in zip(pipe.train_loss_history, ref["losses"]):
        if not math.isclose(got, want, rel_tol=1e-5):
            raise SmokeFailure(f"sharded losses {pipe.train_loss_history} vs {ref['losses']}")
    weight_dev = max(float((whole[n].cpu() - p).abs().max()) for n, p in ref["params"].items())
    if weight_dev > 2e-5:
        raise SmokeFailure(f"sharded weights: max |Δ| {weight_dev}")
    for n, b in ref["stats"].items():
        close(f"BatchNorm {n}", whole[n].cpu(), b, 1e-6, 1e-5)
    norms = [float(t.norm()) for t in ref["m"]]
    errs = [float((g.cpu() - t).norm()) / (nt + 1e-3 * max(norms))
            for g, t, nt in zip(m, ref["m"], norms)]
    if max(errs) > 5e-2 or statistics.median(errs) > 1e-2:
        raise SmokeFailure(f"sharded Adam moments: max {max(errs)}, median "
                           f"{statistics.median(errs)}")
    return {"weight_dev_max": weight_dev, "moment_rel_err_max": max(errs),
            "moment_rel_err_median": statistics.median(errs)}


def timed_collectives(torch, fn) -> tuple[float, float, int]:
    """``(wall s, s inside all_reduce/all_gather, their calls)`` of ``fn()``.
    The card is synchronised before each collective and after ``fn``, so a
    collective's time is its own (gloo stages CUDA tensors through the host
    and returns when done), not the compute it would wait for; ``fn`` runs
    as much slower as those synchronisations cost."""
    dist = torch.distributed
    real = {name: getattr(dist, name) for name in ("all_reduce", "all_gather")}
    spent = [0.0, 0]

    def timed(f):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*args, **kwargs)
            spent[0] += time.perf_counter() - t0
            spent[1] += 1
            return out
        return call

    for name, f in real.items():
        setattr(dist, name, timed(f))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for name, f in real.items():
            setattr(dist, name, f)
    return wall, spent[0], spent[1]


def phase18_rank(workdir: str) -> None:
    """A rank of phase 18's pair (``python3 chip_smoke.py --phase18-rank
    WORKDIR`` with the launcher's environment; both ranks on ``cuda:0`` over
    gloo). (a) the sharded step on meshes (2, 1) and (1, 2); (b) the sharded
    ``predict_batch`` at (2, 1). Writes ``p18_rank<r>.json``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fpn_mt_image_captioning_torch.config import Config, MeshConfig
    from fpn_mt_image_captioning_torch.data.tokenizer import REFERENCE_FILTERS, Tokenizer
    from fpn_mt_image_captioning_torch.ops import fused_decoder as fd
    from fpn_mt_image_captioning_torch.parallel import multihost as mh
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline, resolve_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not mh.maybe_initialize(backend="gloo"):
        raise SmokeFailure("phase 18 rank: no launcher environment")
    rank, world = mh.rank(), mh.world_size()
    dev = resolve_device(None)   # cuda:LOCAL_RANK
    tokenizer = synthetic_tokenizer(Tokenizer, REFERENCE_FILTERS)
    ref = torch.load(Path(workdir) / "p18_reference.pt")
    images, caps = p18_batch()
    n = P18_BATCH // world
    out = {"rank": rank, "device": str(dev)}
    for mesh in P18_MESHES:
        pipe = Pipeline(tokenizer, MAX_LEN, p18_train_config(Config, MeshConfig, mesh), seed=0,
                        device=dev, checkpoint_path=str(Path(workdir) / f"p18_ckpt{rank}"))
        walls = []
        for _ in range(P18_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.train_step(images[rank * n:(rank + 1) * n], caps[rank * n:(rank + 1) * n])
            walls.append(time.perf_counter() - t0)
        name = f"{mesh[0]}x{mesh[1]}"
        out[name] = {"step_s": statistics.median(walls), "step_s_runs": walls,
                     "losses": pipe.train_loss_history,
                     "sharded_parameters": sum(d is not None for d in pipe._placements.values()),
                     **p18_compare_step(torch, pipe, ref)}
        # one more step with its collectives timed (after the comparison)
        wall, spent, calls = timed_collectives(torch, lambda: pipe.train_step(
            images[rank * n:(rank + 1) * n], caps[rank * n:(rank + 1) * n]))
        out[name].update(timed_step_s=wall, collectives_s=spent, collective_calls=calls,
                         collectives_share=spent / wall)
        del pipe
        torch.cuda.empty_cache()
    served = Pipeline(tokenizer, MAX_LEN, Config(beam_search_n=BEAM, compute_dtype="bfloat16",
                                                 decode_batch=P18_BATCH,
                                                 mesh=MeshConfig(enabled=True)),
                      seed=0, device=dev)
    pimgs = p18_predict_images()[rank * n:(rank + 1) * n]
    served.predict_batch(pimgs)   # warm-up: the first call loads the kernels' libraries
    reset_all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seqs, lengths = served.predict_batch(pimgs)
    wall = time.perf_counter() - t0
    counts = read_all_counts()
    steps = fd.decoder_logsoftmax_topk.launches
    check_decode_counts(fd, decode_per_step(fd), steps)
    seqs, lengths = mh.gather_rows(seqs), mh.gather_rows(lengths)
    if rank == 0:
        want = np.load(Path(workdir) / "p18_reference.npz")
        if not (np.array_equal(seqs, want["seqs"]) and np.array_equal(lengths, want["lengths"])):
            raise SmokeFailure("phase 18 (b): the sharded predict_batch differs from one "
                               "process's")
    out["predict"] = {"wall_s": wall, "decode_steps": steps, "launches": counts,
                      "rows": int(n), "sequences_equal": True}
    (Path(workdir) / f"p18_rank{rank}.json").write_text(json.dumps(out))
    mh.barrier("phase18_done")
    torch.distributed.destroy_process_group()


def phase18_train_main(workdir: str) -> None:
    """A rank of (c): ``python -m torch.distributed.run --nproc_per_node=2
    chip_smoke.py --phase18-train-main WORKDIR``. The ``train`` main over
    phase 15's corpus (24 PNGs, 16 for validation) at 2+2 layers, mesh on,
    gloo (two ranks share the card), 2 epochs with an evaluation each;
    CIDEr is the real ``MetricEval``'s plus the epoch number, so that epoch 2
    saves a checkpoint. Writes ``p18_main_rank<r>.json``."""
    import contextlib

    import torch

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fpn_mt_image_captioning_torch.config import Config, MeshConfig
    from fpn_mt_image_captioning_torch.data.dataset import get_coco_images_dataset
    from fpn_mt_image_captioning_torch.data.metrics import MetricEval
    from fpn_mt_image_captioning_torch.parallel import multihost as mh
    from fpn_mt_image_captioning_torch.train.__main__ import main as train_main

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the launcher numbers the ranks' cards 0 and 1; this machine has one,
    # so both take cuda:0, as two one-card hosts would
    os.environ["LOCAL_RANK"] = "0"
    mh.maybe_initialize(backend="gloo")
    rank = mh.rank()
    src, root = Path(workdir) / "train_main", Path(workdir) / "p18_main"
    root.mkdir(exist_ok=True)
    cfg = Config(datadir=str(src / "data"), epochs=2, batch_size=10, n_epoch_to_evaluate=1,
                 n_val_dataset=TRAIN_MAIN_VAL, warm_up_steps=TRAIN_WARMUP,
                 num_layers=P18_MAIN_LAYERS, mesh=MeshConfig(enabled=True),
                 tokenizer_filename=str(src / "tokenizer.json"),
                 additional_filename=str(root / "info.json"),
                 transformer_checkpoint_path=str(root / "ckpt"),
                 transformer_weight_path=str(root / "weights.msgpack"),
                 result_dir=str(root / "results"))
    real, scored = MetricEval.__call__, []

    def epoch_scored(self, path):
        scored.append(real(self, path))
        return scored[-1] + len(scored)

    MetricEval.__call__ = epoch_scored
    t0 = time.perf_counter()
    with contextlib.chdir(root), contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        master = train_main(cfg)
    wall = time.perf_counter() - t0
    dataset, _, _ = get_coco_images_dataset(cfg.datadir, cfg.datatype_train, config=cfg)
    (root / f"rank{rank}.json").write_text(json.dumps({
        "losses": master.train_loss_history, "wall_s": wall, "device": str(master.device),
        "shard": [os.path.basename(p) for p in dataset.img_paths],
        "ckpt_steps": master.ckpt_manager.all_steps(), "cider": scored}))
    mh.barrier("phase18_main_done")
    torch.distributed.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def p18_run(cmds, timeout: float, what: str) -> None:
    """Start the processes of ``cmds`` ((argv, env) pairs) together and wait
    for all (``timeout`` seconds at most; killed on expiry); any nonzero exit
    raises with the tail of its output."""
    procs = [subprocess.Popen(argv, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for argv, env in cmds]
    t0 = time.perf_counter()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise SmokeFailure(f"phase 18 {what}: no end within {timeout} s")
    bad = [(p.returncode, o[-4000:]) for p, o in zip(procs, outs) if p.returncode]
    if bad:
        raise SmokeFailure(f"phase 18 {what}: exit codes and output tails {bad}")


def p18_world_of_one(torch, dev, Config, Pipeline, tokenizer, workdir) -> dict:
    """(d) A world of one rank on NCCL with an explicit 1 × 1 mesh: three
    sharded steps (``make_sharded_train_step``, the flagship in float32 at
    batch 4, dropout 0.1) against three ``train_step``s from the same
    weights: the first loss bitwise (lr(0) = 0 and a forward pass is
    deterministic), every loss within rtol 1e-5 and every weight within
    atol 2e-5 (the card's convolution gradients sum in another order run to
    run, tests/test_torch_cuda_train.py); the sharded fused beam search
    equals ``beam_search`` on 8 images bitwise."""
    import numpy as np

    from fpn_mt_image_captioning_torch.config import MeshConfig
    from fpn_mt_image_captioning_torch.decode.beam_search import beam_search
    from fpn_mt_image_captioning_torch.parallel.mesh import make_mesh
    from fpn_mt_image_captioning_torch.parallel.train import (make_sharded_beam_search,
                                                              make_sharded_train_step,
                                                              shard_state)

    dist = torch.distributed
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(MeshConfig(), "cuda")
        images, caps = train_batch(np.random.default_rng(1802), P18_ONE_BATCH, MAX_LEN)
        cfg = Config(batch_size=P18_ONE_BATCH, compute_dtype="float32")
        plain, sharded = (Pipeline(tokenizer, MAX_LEN, cfg, seed=0, device=dev,
                                   checkpoint_path=str(Path(workdir) / f"p18_one_{k}"))
                          for k in ("plain", "sharded"))
        state, placements = shard_state(mesh, sharded.state)
        step = make_sharded_train_step(mesh, sharded.learning_rate, placements, seed=cfg.seed,
                                       dropout_rate=cfg.dropout_rate)
        want = [plain.train_step(images, caps) for _ in range(3)]
        got = []
        for _ in range(3):
            state, loss = step(state, torch.as_tensor(images, device=dev),
                               torch.as_tensor(caps.astype(np.int64), device=dev))
            got.append(float(loss))
        a, b = plain.state.model.named_parameters(), dict(state.model.named_parameters())
        weight_dev = max(float((p - b[k]).abs().max()) for k, p in a)
        if got[0] != want[0] or not all(math.isclose(x, y, rel_tol=1e-5)
                                        for x, y in zip(got, want)) or weight_dev > 2e-5:
            raise SmokeFailure(f"(d) sharded step: losses {got} vs {want}, weights max |Δ| "
                               f"{weight_dev}")
        enc = plain.encode(p18_predict_images()[:8])
        kw = dict(beam_n=BEAM, max_len=MAX_LEN, start_token=plain.start_token,
                  end_token=plain.end_token)
        ws, wl, _ = beam_search(plain.transformer, enc, fused=True, packed=plain.packed, **kw)
        gs, gl, _ = make_sharded_beam_search(mesh, plain.transformer, packed=plain.packed,
                                             **kw)(enc)
        if not (torch.equal(ws, gs) and torch.equal(wl, gl)):
            raise SmokeFailure("(d) the sharded beam search differs from beam_search")
        return {"backend": dist.get_backend(), "mesh": list(mesh.shape), "losses": got,
                "one_process_losses": want, "weight_dev_max": weight_dev,
                "beam_bitwise": True}
    finally:
        dist.destroy_process_group()


def phase_18(fd, torch, dev, Config, Pipeline, tokenizer, workdir) -> dict:
    """Phase 18, several ranks: one pair of rank processes on ``cuda:0``
    over gloo (``LOCAL_RANK`` 0 in each, as two one-card hosts; NCCL
    refuses two ranks on one card) runs (a) and (b) against this process's
    references; (c) the ``train`` main under ``torch.distributed.run``; (d)
    a world of one rank on NCCL here. The two ranks time-share one card, so
    no wall here is a scaling figure. Returns rank 0's decode launches of
    (b)."""
    t0 = time.perf_counter()
    ref = p18_reference(torch, dev, Config, Pipeline, tokenizer, workdir)
    me = str(Path(__file__).resolve())
    port = free_port()
    env = lambda r: {**os.environ, "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                     "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    p18_run([([sys.executable, me, "--phase18-rank", workdir], env(r)) for r in (0, 1)],
            P18_TIMEOUT - (time.perf_counter() - t0), "(a, b) pair")
    ranks = [json.loads((Path(workdir) / f"p18_rank{r}.json").read_text()) for r in (0, 1)]
    for mesh in P18_MESHES:
        name = f"{mesh[0]}x{mesh[1]}"
        if ranks[0][name]["losses"] != ranks[1][name]["losses"]:
            raise SmokeFailure(f"phase 18 (a) {name}: the ranks report other losses")
    say("parallel_step", card=card_line(), batch=P18_BATCH, steps=P18_STEPS,
        dtype="float32", tf32=False, one_process=ref,
        **{f"mesh_{k}": ranks[0][k] for k in ("2x1", "1x2")},
        rank1_step_s={k: ranks[1][k]["step_s"] for k in ("2x1", "1x2")},
        note="two ranks time-share one card over gloo: no scaling figure")
    say("parallel_predict", card=card_line(), mesh="2x1", global_batch=P18_BATCH, beam=BEAM,
        dtype="bfloat16", **{f"rank{r}": {k: v for k, v in ranks[r]["predict"].items()
                                           if k != "launches"} for r in (0, 1)},
        launches_rank0={k: v for k, v in ranks[0]["predict"]["launches"].items() if v})
    # (c) the train main under the launcher
    t1 = time.perf_counter()
    p18_run([([sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2",
               "--master_addr=127.0.0.1", f"--master_port={free_port()}", me,
               "--phase18-train-main", workdir], dict(os.environ))],
            P18_TIMEOUT - (time.perf_counter() - t0), "(c) train main")
    root = Path(workdir) / "p18_main"
    mains = [json.loads((root / f"rank{r}.json").read_text()) for r in (0, 1)]
    shards = [set(m["shard"]) for m in mains]
    logs = os.listdir(root / "logs" / "transformer")
    results = os.listdir(root / "results")
    if mains[0]["losses"] != mains[1]["losses"] or not all(map(math.isfinite,
                                                               mains[0]["losses"])):
        raise SmokeFailure(f"phase 18 (c): losses {[m['losses'] for m in mains]}")
    if len(shards[0]) != len(shards[1]) or shards[0] & shards[1] or \
            len(shards[0] | shards[1]) != TRAIN_MAIN_IMAGES:
        raise SmokeFailure(f"phase 18 (c): corpus shards {shards}")
    if len(logs) != 1 or len(results) != 1 or mains[0]["ckpt_steps"] != [2] or \
            mains[1]["ckpt_steps"] != [2] or not (root / "weights.msgpack").is_file():
        raise SmokeFailure(f"phase 18 (c): logs {logs}, results {results}, checkpoints "
                           f"{[m['ckpt_steps'] for m in mains]}")
    say("parallel_train_main", card=card_line(), ranks=2, backend="gloo",
        layers=P18_MAIN_LAYERS, wall_s=time.perf_counter() - t1,
        main_wall_s=[m["wall_s"] for m in mains], losses=mains[0]["losses"],
        shard_images=len(shards[0]), cider=mains[0]["cider"], checkpoint_steps=[2],
        log_dirs=len(logs), result_files=results)
    one = p18_world_of_one(torch, dev, Config, Pipeline, tokenizer, workdir)
    say("parallel_world_of_one", card=card_line(), **one)
    say("phase18", card=card_line(), seconds=time.perf_counter() - t0)
    return ranks[0]["predict"]["launches"]


# ---------------------------------------------------------------------------
# phase 19: convergence on the card, the golden Orbax checkpoint, the Keras
# .h5 writer, the anchors and the detection losses
# ---------------------------------------------------------------------------
CONVERGENCE_EPOCHS = 20
GOLDEN_TORCH = Path("tests") / "golden_torch"


def phase19_convergence(fd, workdir) -> dict:
    """(a) The d256 proxy (256², d 256, 3+3 layers, dff 1024, 8 heads, batch
    16) on the synthetic classful corpus for ``CONVERGENCE_EPOCHS`` epochs,
    an evaluation every 5 on the decode kernels, through the port's
    ``train`` main (``scripts/convergence_run.py``), then its best
    checkpoint at beam 8. Counters reset just before and read just after:
    each decode kernel at the decode steps × its launches a step, the
    backbone kernel at 0 (eager encode); the curve held to the convergence
    test's bars. Returns the launch counts."""
    from fpn_mt_image_captioning_torch.scripts import convergence_run

    root = Path(workdir) / "convergence"
    reset_all_counts()
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        summary = convergence_run.run("d256", epochs=CONVERGENCE_EPOCHS,
                                      workspace=str(root / "ws"), out_dir=root / "out")
    counts = read_all_counts()
    nl = convergence_run.SETTINGS["d256"][3]["num_layers"]
    steps = fd.decoder_logsoftmax_topk.launches
    check_decode_counts(fd, {fd.decoder_linear: 6 * nl + 1, fd.decoder_add_layernorm: 3 * nl,
                             fd.decoder_self_attention: nl, fd.decoder_cross_attention: nl,
                             fd.decoder_logsoftmax_topk: 1}, steps)
    if counts["fused_ir_block"] != 0:
        raise SmokeFailure(f"convergence: {counts['fused_ir_block']} backbone launches")
    with open(summary["curve"]) as f:
        scalars = [json.loads(line) for line in f][1:]
    bars = convergence_run.curve_bars(scalars)
    for fault in (bars["loss"], bars["cider"]):
        if fault is not None:
            raise SmokeFailure(f"convergence d256: {fault}")
    say("convergence_d256", card=card_line(), epochs=summary["epochs"],
        train_steps=summary["train_steps"], step_s_median=summary["step_s_median"],
        images_per_s=summary["images_per_s"], evaluate_s=summary["evaluate_s"],
        train_main_s=summary["train_main_s"], beam8_eval_s=summary["beam8_eval_s"],
        best_epoch=summary["best_epoch"], beam8=summary["full_metrics_beam8"],
        decode_steps=steps, launches={k: n for k, n in counts.items()
                                      if k not in PROBE_TPU_KERNELS},
        **{k: v for k, v in bars.items() if k not in ("loss", "cider")})
    return counts


def phase19_orbax(torch) -> None:
    """(b) The golden Orbax checkpoint (``tests/golden_torch/orbax/1``,
    written by the JAX package's manager) read by the port's reader, zstd
    through this machine's libzstd: every leaf bitwise equal to the values
    ``make_orbax_golden.golden_tree`` regenerates from its seed; the port's
    ``CheckpointManager`` lists the step and gives the bfloat16 leaf as
    torch's."""
    import ctypes
    import importlib.util

    import numpy as np

    from fpn_mt_image_captioning_torch.train import orbax_store
    from fpn_mt_image_captioning_torch.train.checkpoint import CheckpointManager

    repo = Path(__file__).resolve().parent
    spec = importlib.util.spec_from_file_location(
        "make_orbax_golden", repo / GOLDEN_TORCH / "make_orbax_golden.py")
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)
    t0 = time.perf_counter()
    got = orbax_store.read_step(golden.DIR / "1")
    read_s = time.perf_counter() - t0
    want = golden.golden_tree(golden.SEED)

    def leaves(tree, prefix=""):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}{k}/") if isinstance(v, dict) else [(prefix + k, v)]

    have, need = dict(leaves(got)), dict(leaves(want))
    if have.keys() != need.keys():
        raise SmokeFailure(f"golden Orbax: leaves {sorted(have)} != {sorted(need)}")
    for k, v in need.items():
        a = np.asarray(have[k])
        if a.dtype != v.dtype or a.shape != v.shape or a.tobytes() != v.tobytes():
            raise SmokeFailure(f"golden Orbax: leaf {k} differs from its seed's")
    manager = CheckpointManager(str(golden.DIR))
    emb = manager.read(1)["params"]["embedding"]
    if manager.all_steps() != [1] or emb.dtype != torch.bfloat16 or \
            emb.view(torch.int16).numpy().tobytes() != need["params/embedding"].tobytes():
        raise SmokeFailure("golden Orbax: the manager's step or bfloat16 leaf differ")
    lib = orbax_store._libzstd()
    lib.ZSTD_versionString.restype = ctypes.c_char_p
    say("orbax_golden", card=card_line(), leaves=len(need), read_s=read_s,
        libzstd=lib.ZSTD_versionString().decode(), bitwise_equal_to_seed=True,
        importable={m: importlib.util.find_spec(m) is not None
                    for m in ("orbax", "tensorstore", "zstandard", "h5py")})


def phase19_h5_writer(torch, dev, workdir, taps16) -> None:
    """(c) The golden Keras ``.h5``'s layers (read by the port's reader)
    written by the port's ``write_keras_h5`` and read back bitwise; the
    backbone imported from the written file has phase 16 (c)'s taps,
    exactly."""
    import numpy as np

    from fpn_mt_image_captioning_torch.utils.weight_import import load_keras_h5, write_keras_h5

    repo = Path(__file__).resolve().parent
    layers = load_keras_h5(repo / GOLDEN / "mobilenet_v2_a035.h5")
    out = Path(workdir) / "written.h5"
    t0 = time.perf_counter()
    write_keras_h5(out, layers)
    write_s = time.perf_counter() - t0
    back = load_keras_h5(out)
    n = 0
    for layer, weights in layers.items():
        for name, arr in weights.items():
            got = back.get(layer, {}).get(name)
            if got is None or got.dtype != arr.dtype or got.shape != arr.shape or \
                    got.tobytes() != np.asarray(arr).tobytes():
                raise SmokeFailure(f".h5 writer: {layer}/{name} does not read back bitwise")
            n += 1
    if back.keys() != layers.keys():
        raise SmokeFailure(".h5 writer: the layers read back differ")
    taps, report, _ = golden_taps(torch, dev, back)
    if not all(torch.equal(a, b) for a, b in zip(taps, taps16)):
        raise SmokeFailure(".h5 writer: the taps differ from phase 16 (c)'s")
    say("h5_writer", card=card_line(), layers=len(layers), datasets=n, write_s=write_s,
        bytes=out.stat().st_size, read_back_bitwise=True, taps_equal_phase16=True,
        report=repr(report))


def phase19_detection(torch, dev) -> None:
    """(d) The anchors and ``box_decode`` at 512² and the four detection
    losses with their gradients on ``cuda:0`` against the same on the CPU
    (seeded inputs, logits up to ±30): boxes within 1e-4 + 1e-6 relative
    (an FMA's rounding at coordinates up to 512), losses and gradients
    within 1e-5 relative (the card sums in another order)."""
    import numpy as np

    from fpn_mt_image_captioning_torch.models import anchors
    from fpn_mt_image_captioning_torch.train import losses

    rng = np.random.default_rng(71)
    a = anchors.all_anchors(SIZE)
    reg = torch.from_numpy((rng.standard_normal((2, len(a), 4)) * 3).astype(np.float32))
    box_err = close("box_decode", anchors.box_decode(a, reg.to(dev), SIZE).cpu(),
                    anchors.box_decode(a, reg, SIZE), atol=1e-4, rtol=1e-6)
    logits = (rng.standard_normal((4, 500, 80)) * 3).astype(np.float32)
    big = rng.random(logits.shape) < 0.1
    logits[big] = np.sign(logits[big]) * 30.0
    labels = (rng.random(logits.shape) < 0.05).astype(np.float32)
    labels[rng.random(logits.shape[:-1]) < 0.1] = -1.0
    pred = rng.random((2, 64, 64, 3)).astype(np.float32)
    target = rng.random((2, 64, 64, 3)).astype(np.float32)
    cases = {"focal": (losses.focal_loss, labels, logits),
             "sigmoid_ce": (lambda z, x: losses.optax_sigmoid_ce(z, x).sum(), labels, logits),
             "weighted_mse": (losses.weighted_mse_loss, target, pred),
             "smooth_l1": (losses.smooth_l1_loss, target, pred * 2)}
    errs = {}
    for name, (fn, first, second) in cases.items():
        out = []
        for d in ("cpu", dev):
            x = torch.tensor(second, device=d, requires_grad=True)
            value = fn(torch.as_tensor(first, device=d), x)
            value.backward()
            out.append((value.detach().cpu(), x.grad.cpu()))
        (cv, cg), (gv, gg) = out
        errs[name] = {"value": close(f"{name} value", gv, cv, atol=0.0, rtol=1e-5),
                      "grad": close(f"{name} gradient", gg, cg,
                                    atol=1e-5 * cg.abs().max().item(), rtol=1e-5)}
    say("detection", card=card_line(), anchors=len(a), box_decode_max_abs_err=box_err,
        losses=errs)


def phase_19(fd, torch, dev, workdir, taps16) -> dict:
    t0 = time.perf_counter()
    counts = phase19_convergence(fd, workdir)
    phase19_orbax(torch)
    phase19_h5_writer(torch, dev, workdir, taps16)
    phase19_detection(torch, dev)
    say("phase19", card=card_line(), seconds=time.perf_counter() - t0)
    return counts


def greedy_of(pipe, images):
    """``greedy_decode`` of ``images`` on ``pipe``'s weights, as numpy."""
    from fpn_mt_image_captioning_torch.decode.beam_search import greedy_decode

    seqs, lengths = greedy_decode(
        pipe.transformer, pipe.encode(images), max_len=MAX_LEN,
        start_token=pipe.start_token, end_token=pipe.end_token)
    return seqs.cpu().numpy(), lengths.cpu().numpy()


def main() -> int:
    if sys.argv[1:2] == ["--phase18-rank"]:
        phase18_rank(sys.argv[2])
        return 0
    if sys.argv[1:2] == ["--phase18-train-main"]:
        phase18_train_main(sys.argv[2])
        return 0
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
        torch.cuda.empty_cache()
        phase_train_flagship(torch, dev, Config, Pipeline, tokenizer, workdir)
        phase_train_card_vs_cpu(torch, dev, Config, Pipeline, tokenizer, workdir)
        train_counts = phase_train_main(fd, fb, torch, Config, Pipeline, tokenizer, workdir)
        torch.cuda.empty_cache()
        backbones_counts, golden_taps_16 = phase_16(fd, torch, dev, Config, Pipeline,
                                                    tokenizer, variables, workdir)
        torch.cuda.empty_cache()
        artifact_counts_ = phase_17(fd, torch, build, Config, workdir)
        torch.cuda.empty_cache()
        parallel_counts = phase_18(fd, torch, dev, Config, Pipeline, tokenizer, workdir)
        torch.cuda.empty_cache()
        convergence_counts = phase_19(fd, torch, dev, workdir, golden_taps_16)
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
                        "decode_modes_launches": modes_counts[k.__name__],
                        "train_launches": train_counts[k.__name__],
                        "backbones_launches": backbones_counts[k.__name__],
                        "artifact_launches": artifact_counts_[k.__name__],
                        "parallel_launches": parallel_counts[k.__name__],
                        "convergence_launches": convergence_counts[k.__name__]})
    say("timing", **TIMING)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
