#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card: the quickest proof that the
port builds, is right, and captions on the GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises, so the script exits
non-zero without its last line):

  1. environment — the card (nvidia-smi name and power limit), torch and CUDA
     versions; TF32 is switched off for matmuls and convolutions, so float32
     means float32;
  2. build — every CUDA kernel compiled from the sources in this checkout;
  3. kernel vs plain — each hand-written kernel of the fused decode step held
     to its plain PyTorch version at the flagship decode shapes (B·beam = 512,
     d 512, 8 heads, dff 2048, 6 layers, Lpad 64, Lenc 16, vocab 2000):
     float32 at the JAX tests' bar (atol 3e-4, ids equal), bfloat16 at
     |err| <= 1e-2 + 1e-2·|plain| (one bf16 rounding of the result, 2^-8
     relative); with each kernel's time beside its plain version's, the one
     PyTorch call for the same function where there is one, and its bound;
  4. whole step — ``fused_decode_step`` held to
     ``fused_decode_step_reference`` over 8 state-synchronised steps (a beam
     reorder, finished rows, the kernel's chosen tokens fed to both); scores
     within atol 3e-4 (float32) / 0.1 (bfloat16), ids equal wherever the
     plain version's neighbouring candidates are further apart than that;
  5. small input — ``Pipeline.predict_batch`` of a small float32 model on the
     card against the same model on the CPU (plain versions): equal tokens;
  6. main path — ``Pipeline.predict_batch`` at full width (512² uint8 images,
     mobilenet224_1.0, d_model 512, 6+6 layers, dff 2048, 8 heads, beam 8,
     max_seq_len 60, vocab 2000, bfloat16; seeded weights with BatchNorm
     statistics and biases perturbed) on 8 images and then 64 (512 decode
     rows), with ``to_caption``: a warm-up, five timed runs (median wall),
     five timed encodes and one run under the CUDA profiler each; launch
     counters reset just before and read just after, each non-zero and equal
     to the decode steps × its launches per step.

Then the kernel table as one JSON line, the card's name and power limit, and
``{"ok": true, "device": {...}}`` as the last line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense): the bound of each kernel is the
# larger of bytes / memory rate and operations / the rate for their type.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

B, BEAM, D, H, DFF, NL, LENC, V, MAX_LEN = 64, 8, 512, 8, 2048, 6, 16, 2000, 60
BK = B * BEAM
TPU_KERNEL = "fpn_mt_image_captioning_tpu/ops/fused_decoder.py:164"
SOURCE = "fpn_mt_image_captioning_torch/csrc/fused_decoder.cu"


class SmokeFailure(RuntimeError):
    pass


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench(fn, iters: int = 20, reps: int = 5) -> tuple[float, float]:
    """``(device_ms, wall_ms)`` of one call of ``fn``. Device time is the sum
    of its kernels' durations as the CUDA profiler records them over
    ``iters`` calls, after warm-up. A Python loop of small launches is bound
    by the host, so CUDA events around the loop time the host: their median
    over ``reps`` runs is the wall time per call. Raises if the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.self_device_time_total for e in prof.key_averages())
    if device_us <= 0:
        raise SmokeFailure("the CUDA profiler recorded no device time")
    return device_us / iters / 1e3, statistics.median(times)


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

        # (a) every linear shape of the step
        for name, k, n, act, out_f32 in (
                ("qkv", D, 3 * D, "none", False), ("out", D, D, "none", True),
                ("cross_q", D, D, "none", False), ("ffn1", D, DFF, "leaky_relu", False),
                ("ffn2", DFF, D, "none", True), ("vocab", D, V, "none", True),
                ("odd", 100, 36, "gelu", False)):   # K, N not multiples of 8
            x = rand(BK, k, dtype=dt)
            w = rand(k, n, scale=math.sqrt(2.0 / k), dtype=dt)
            b = rand(n, scale=0.1)
            got = fd.decoder_linear(x, w, b, act, out_f32)
            want = fd.decoder_linear_reference(x, w, b, act, out_f32)
            err = close(f"decoder_linear[{name},{dt_name}]", got, want, **tol)
            ms, wall = bench(lambda: fd.decoder_linear(x, w, b, act, out_f32))
            plain, plain_wall = bench(lambda: fd.decoder_linear_reference(x, w, b, act, out_f32))
            line[f"linear_{name}_{dt_name}"] = {"err": err, "ms": ms, "plain_ms": plain, "wall_ms": wall, "plain_wall_ms": plain_wall}
            if name == "qkv" and not f32:
                wt, bt = w.t().contiguous(), b.to(dt)
                lib, lib_wall = bench(lambda: torch.nn.functional.linear(x, wt, bt))
                nbytes = (BK * k + k * n + BK * n) * esz + n * 4
                table["decoder_linear"] = dict(
                    shape=f"qkv M={BK} K={k} N={n} bf16", max_abs_err=err, ms=ms,
                    plain_ms=plain, library_ms=lib, bound=bound(nbytes, 2 * BK * k * n, dt_name))

        # (b) add + LayerNorm, residual in the compute dtype and in float32
        for rname, r_dt in (("r_t", dt), ("r_f32", torch.float32)):
            y, r = rand(BK, D), rand(BK, D, dtype=r_dt)
            gamma, beta = 1 + rand(D, scale=0.1), rand(D, scale=0.1)
            got_f, got_t = fd.decoder_add_layernorm(y, r, gamma, beta, dt)
            want_f, want_t = fd.decoder_add_layernorm_reference(y, r, gamma, beta, dt)
            err = max(close(f"decoder_add_layernorm[{rname},{dt_name}] f32", got_f, want_f,
                            atol=3e-4),
                      close(f"decoder_add_layernorm[{rname},{dt_name}]", got_t, want_t, **tol))
            ms, wall = bench(lambda: fd.decoder_add_layernorm(y, r, gamma, beta, dt))
            plain, plain_wall = bench(lambda: fd.decoder_add_layernorm_reference(y, r, gamma, beta, dt))
            line[f"layernorm_{rname}_{dt_name}"] = {"err": err, "ms": ms, "plain_ms": plain, "wall_ms": wall, "plain_wall_ms": plain_wall}
            if rname == "r_t" and not f32:
                v = y + r.float()
                lib, lib_wall = bench(lambda: torch.nn.functional.layer_norm(v, (D,), gamma, beta, 1e-6))
                nbytes = BK * D * (4 + esz) + 2 * D * 4 + BK * D * (4 + esz)
                table["decoder_add_layernorm"] = dict(
                    shape=f"rows={BK} d={D} bf16 (library: layer_norm of y + r)",
                    max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                    bound=bound(nbytes, 8 * BK * D, "float32"))

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
    """One traced run of ``fn``: wall time, the device's busy time (sum of
    kernel and copy durations; kernels of one stream do not overlap) and
    idle share, and the device time by kernel name, largest first."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return dict(wall_ms=wall_ms, device_busy_ms=busy, device_idle_share=1 - busy / wall_ms,
                top=[{"kernel": k[:90], "ms": ms, "count": c} for k, ms, c in rows[:12]])


def phase_main(fd, torch, dev, pipe):
    """Pipeline.predict_batch at full width: 8 images, then 64."""
    import numpy as np

    rng = np.random.default_rng(2024)
    size = pipe.config.image_input_size
    per_step = {fd.decoder_linear: 6 * NL + 1, fd.decoder_add_layernorm: 3 * NL,
                fd.decoder_self_attention: NL, fd.decoder_cross_attention: NL,
                fd.decoder_logsoftmax_topk: 1}
    out = {}
    fd.reset_launch_counts()
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
    counts = {k.__name__: k.launches for k in fd.KERNELS}
    for k, n in per_step.items():
        if k.launches == 0 or k.launches != steps * n:
            raise SmokeFailure(f"{k.__name__}: {k.launches} launches for {steps} steps "
                               f"× {n} per step")
    traces = {b: out[b].pop("trace") for b in out}
    say("main_path", batch8=out[8], batch64=out[64], total_decode_steps=steps,
        launches=counts)
    for b, trace in traces.items():
        say(f"trace_batch{b}", **trace)
    return counts


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
    from fpn_mt_image_captioning_torch.models.backbones.mobilenet_v2 import BatchNorm32
    from fpn_mt_image_captioning_torch.ops import _build
    from fpn_mt_image_captioning_torch.ops import fused_decoder as fd
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
    libs = _build.build()
    say("build", seconds=time.perf_counter() - t0, libraries=[p.name for p in libs.values()])

    table = phase_kernels(fd, torch, dev)

    tokenizer = synthetic_tokenizer(Tokenizer, REFERENCE_FILTERS)
    cfg = Config(beam_search_n=BEAM, compute_dtype="bfloat16")
    pipe = Pipeline(tokenizer, MAX_LEN, cfg, seed=0, device=dev)
    with torch.no_grad():   # perturb BN statistics and biases (they init to 0/1)
        g = torch.Generator().manual_seed(7)
        for m in pipe.transformer.modules():
            if isinstance(m, BatchNorm32):
                m.running_mean += 0.1 * torch.randn(m.running_mean.shape, generator=g).to(dev)
                m.running_var *= (0.5 + torch.rand(m.running_var.shape, generator=g)).to(dev)
        for name, p in pipe.transformer.named_parameters():
            if name.rsplit(".", 1)[-1] in ("bias", "bq", "bo", "kv_bias"):
                p += (0.1 * torch.randn(p.shape, generator=g)).to(dev, p.dtype)
        pipe.packed = fd.pack_decoder_weights(pipe.transformer, pipe.dtype)

    for dt_name in ("float32", "bfloat16"):
        phase_whole_step(fd, torch, dev, pipe, dt_name)
    phase_small_input(torch, dev, Config, Pipeline, tokenizer)
    counts = phase_main(fd, torch, dev, pipe)

    kernels = []
    for k in fd.KERNELS:
        row = table[k.__name__]
        bound_ms, bound_by = row.pop("bound")
        kernels.append({"name": k.__name__, "route": "cuda", "source": SOURCE,
                        "replaces": TPU_KERNEL, "launches": counts[k.__name__], **row,
                        "bound_ms": bound_ms, "bound_by": bound_by})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
