"""The fused decode step: every decoder layer, the vocabulary projection,
log-softmax, beam freeze and per-row top-k for one token position of all
B·beam rows (port of ``fpn_mt_image_captioning_tpu/ops/fused_decoder.py``).

The TPU kernel ``_decoder_kernel`` did this in ONE launch, carrying the hidden
state across a sequential grid in VMEM. Blocks on a GPU run in no order, so
``fused_decode_step`` issues a fixed sequence of hand-written CUDA kernels
(``csrc/fused_decoder.cu``) per layer instead — 11 per layer plus 2 for the
vocabulary:

  (a) ``decoder_linear``          Y = act(X·W + b), float32 accumulation
  (b) ``decoder_add_layernorm``   LN(y + r), float32 statistics, eps 1e-6
  (c) ``decoder_self_attention``  cache write + ancestry-gathered attention
  (d) ``decoder_cross_attention`` attention over the per-item encoder K/V
  (e) ``decoder_logsoftmax_topk`` log-softmax, beam freeze, score add, top-k

Each wrapper takes its kernel's plain PyTorch version (``*_reference``) when
the tensor it is given lies on the CPU, launches the kernel on a CUDA tensor,
and raises on anything else; each counts its launches in ``.launches``.
``fused_decode_step_reference`` is the whole step built from the plain
versions: the CPU route, and what the kernels are held to on the card.

Layouts (d = d_model, f = dff, V = vocabulary, BK = B·beam):
  packed weights in (in, out) layout, stacked over layers, compute dtype;
  biases and LayerNorm parameters float32;
  self caches (N, Lpad, BK, d), position-major, updated in place;
  cross K/V (N, Lenc, B, 2d), stored per batch item and shared by its beams.
"""

from __future__ import annotations

import ctypes
import functools
import math
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ._build import check, launched, load_library, on_cpu, stream

__all__ = [
    "FUSED_ACTIVATIONS", "KERNELS", "round_up", "pack_decoder_weights",
    "init_fused_cache", "fused_decode_step", "fused_decode_step_reference",
    "decoder_linear", "decoder_linear_reference",
    "decoder_add_layernorm", "decoder_add_layernorm_reference",
    "decoder_self_attention", "decoder_self_attention_reference",
    "decoder_cross_attention", "decoder_cross_attention_reference",
    "decoder_logsoftmax_topk", "decoder_logsoftmax_topk_reference",
    "reset_launch_counts", "LIBRARY", "KERNEL_OPS", "PLAIN_OPS", "decode_step_with",
    "LinearPlan", "linear_plan",
]

# FFN activations the kernels implement (all of models/layers.py)
FUSED_ACTIVATIONS = frozenset({"leaky_relu", "relu", "relu6", "gelu"})
_ACT_CODE = {"none": 0, "leaky_relu": 1, "relu": 2, "relu6": 3, "gelu": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
LN_EPS = 1e-6
# above this head width the attention kernels may take their wide path, which
# keeps each row's context in a float32 scratch row between stages
WIDE_HEAD_DIM = 128
# decoder_linear's wgmma kernel: N and K tiles (one 128-byte swizzle row of
# bf16), the largest portable thread-block cluster, the H100's SMs
LINEAR_BN = LINEAR_BK = 64
MAX_CLUSTER = 8
H100_SMS = 132
SPLIT_DEEP = 8   # K slices a split CTA keeps for the split to crowd the SMs


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# packing and cache
# ---------------------------------------------------------------------------
@torch.no_grad()
def pack_decoder_weights(model, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Stack the decoder's per-layer weights of a ``Transformer`` along a
    leading layer axis, matrices in (in, out) layout and ``dtype``, biases and
    LayerNorm parameters float32:

      wqkv (N, d, 3d)  bqkv (N, 3d)    — self-attn q|k|v fused
      wo   (N, d, d)   bo   (N, d)
      wcq  (N, d, d)   bcq  (N, d)     — cross-attn query
      wco  (N, d, d)   bco  (N, d)
      wkv_x(N, d, 2d)  bkv_x(N, 2d)    — cross-attn k|v (applied to enc output)
      w1   (N, d, f)   b1   (N, f)
      w2   (N, f, d)   b2   (N, d)
      ln   (N, 6, d)                   — LN1..3 scale, bias
      wf   (d, V)      bf   (V,)       — vocabulary projection (not padded)

    and ``layers``: per layer, views of that layer's slices (``ln`` unbound
    into its six rows), made once here so a decode step indexes nothing.
    """
    layers = [getattr(model.decoder, f"layer_{l}") for l in range(model.num_layers)]
    f32 = torch.float32

    def w(lin):
        return lin.weight.t()

    def stack(fn, dt=dtype):
        return torch.stack([fn(L) for L in layers]).to(dt).contiguous()

    packed = {
        "wqkv": stack(lambda L: torch.cat([w(L.mha1.wq), w(L.mha1.wk), w(L.mha1.wv)], 1)),
        "bqkv": stack(lambda L: torch.cat([L.mha1.wq.bias, L.mha1.wk.bias, L.mha1.wv.bias]), f32),
        "wo": stack(lambda L: w(L.mha1.out)),
        "bo": stack(lambda L: L.mha1.out.bias, f32),
        "wcq": stack(lambda L: w(L.mha2.wq)),
        "bcq": stack(lambda L: L.mha2.wq.bias, f32),
        "wco": stack(lambda L: w(L.mha2.out)),
        "bco": stack(lambda L: L.mha2.out.bias, f32),
        "wkv_x": stack(lambda L: torch.cat([w(L.mha2.wk), w(L.mha2.wv)], 1)),
        "bkv_x": stack(lambda L: torch.cat([L.mha2.wk.bias, L.mha2.wv.bias]), f32),
        "w1": stack(lambda L: w(L.ffn.ffn1)),
        "b1": stack(lambda L: L.ffn.ffn1.bias, f32),
        "w2": stack(lambda L: w(L.ffn.ffn2)),
        "b2": stack(lambda L: L.ffn.ffn2.bias, f32),
        "ln": stack(lambda L: torch.stack([
            L.layernorm1.weight, L.layernorm1.bias, L.layernorm2.weight,
            L.layernorm2.bias, L.layernorm3.weight, L.layernorm3.bias]), f32),
        "wf": w(model.final_layer).to(dtype).contiguous(),
        "bf": model.final_layer.bias.to(f32).contiguous(),
    }
    step_keys = ("wqkv", "bqkv", "wo", "bo", "wcq", "bcq", "wco", "bco", "w1", "b1", "w2", "b2")
    packed["layers"] = [{**{k: packed[k][l] for k in step_keys}, "ln": packed["ln"][l].unbind(0)}
                        for l in range(len(layers))]
    return packed


@torch.no_grad()
def init_fused_cache(packed: dict, enc_output: torch.Tensor, beam: int, max_len: int) -> dict:
    """Zero self caches (N, Lpad, B·beam, d) with Lpad = round_up(max_len+1, 8),
    and the cross K/V of every layer projected once per batch item,
    (N, Lenc, B, 2d). ``enc_output`` is un-tiled (B, Lenc, d); an empty one
    (Lenc = 0, what a 64² input encodes to) raises ValueError, as the
    JAX package's ``fused_decode_step`` does over it."""
    _check_lenc(enc_output.shape[1])
    n, d, _ = packed["wqkv"].shape
    dtype = packed["wqkv"].dtype
    lpad = round_up(max_len + 1, 8)
    kv_cross = torch.einsum("bld,nde->nlbe", enc_output.to(dtype), packed["wkv_x"])
    kv_cross = (kv_cross + packed["bkv_x"][:, None, None, :]).to(dtype).contiguous()
    bk = enc_output.shape[0] * beam
    zeros = functools.partial(torch.zeros, (n, lpad, bk, d), dtype=dtype, device=enc_output.device)
    return {"k_self": zeros(), "v_self": zeros(), "kv_cross": kv_cross}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _activate(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "none":
        return y
    if act == "leaky_relu":
        return torch.where(y > 0, y, 0.2 * y)
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "relu6":
        return torch.clamp(y, 0.0, 6.0)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    raise ValueError(f"unsupported activation {act!r}")


def decoder_linear_reference(x, w, b, act: str = "none", out_f32: bool = False):
    """act(x·w + b) in float32; cast back to x's dtype unless ``out_f32``."""
    y = _activate(x.float() @ w.float() + b, act)
    return y if out_f32 else y.to(x.dtype)


def decoder_add_layernorm_reference(y, r, gamma, beta, out_dtype):
    """LN(y + r) in float32 (mean, then mean of squared deviations, eps 1e-6);
    returns the float32 result and its cast to ``out_dtype``."""
    v = y + r.float()
    c = v - v.mean(-1, keepdim=True)
    o = c * torch.rsqrt((c * c).mean(-1, keepdim=True) + LN_EPS) * gamma + beta
    return o, o.to(out_dtype)


def _attend(q, k, v, num_heads):
    """q (BK, d); k, v (P, BK, d): per-row, per-head softmax attention over
    the P positions in float32; context cast to q's dtype."""
    bk, d = q.shape
    dh = d // num_heads
    qh = q.float().reshape(bk, num_heads, dh) * (1.0 / math.sqrt(dh))
    kh = k.float().reshape(-1, bk, num_heads, dh)
    vh = v.float().reshape(-1, bk, num_heads, dh)
    w = torch.softmax(torch.einsum("rhe,prhe->rhp", qh, kh), dim=-1)
    return torch.einsum("rhp,prhe->rhe", w, vh).reshape(bk, d).to(q.dtype)


def decoder_self_attention_reference(qkv, k_self, v_self, layer: int, pos: int,
                                     src_t, beam: int, num_heads: int):
    """Writes k_t/v_t (from the fused (BK, 3d) projection) into the caches at
    [layer, pos] IN PLACE, and attends over positions < pos through the beam
    ancestry (physical row (row // beam) * beam + src_t[p, row]) plus the
    current position's fresh k_t/v_t."""
    bk = qkv.shape[0]
    q, k_t, v_t = qkv.chunk(3, dim=1)
    k_self[layer, pos] = k_t
    v_self[layer, pos] = v_t
    rows = torch.arange(bk, device=qkv.device)
    phys = (rows // beam) * beam + src_t[:pos].long()                   # (pos, BK)
    p_idx = torch.arange(pos, device=qkv.device)[:, None]
    k = torch.cat([k_self[layer][p_idx, phys], k_t[None]])
    v = torch.cat([v_self[layer][p_idx, phys], v_t[None]])
    return _attend(q, k, v, num_heads)


def _check_lenc(lenc: int) -> None:
    if lenc == 0:
        raise ValueError("cross-attention over an empty encoder output (Lenc = 0): the "
                         "softmax has no position to weigh (the JAX package's "
                         "fused_decode_step raises on it too)")


def decoder_cross_attention_reference(q, kv_cross, layer: int, beam: int, num_heads: int):
    """Attention of each row over its batch item's (row // beam) encoder K/V;
    raises ValueError over an empty encoder output."""
    _check_lenc(kv_cross.shape[1])
    d = q.shape[1]
    kv = kv_cross[layer][:, torch.arange(q.shape[0], device=q.device) // beam]  # (Lenc, BK, 2d)
    return _attend(q, kv[..., :d], kv[..., d:], num_heads)


def decoder_logsoftmax_topk_reference(logits, scores, finished, topk: int):
    """log-softmax over V; finished rows become [0, -1e9, …] (pad at zero
    cost) by ``fin*pad_row + (1-fin)*lp``; + running scores; the top ``topk``
    (score, id) pairs per row, descending, ties to the lowest id."""
    m = logits.max(-1, keepdim=True).values
    lp = logits - (m + torch.log(torch.exp(logits - m).sum(-1, keepdim=True)))
    col = torch.arange(logits.shape[-1], device=logits.device)
    pad_row = torch.where(col == 0, 0.0, -1e9)
    fin = finished.reshape(-1, 1)
    total = fin * pad_row + (1.0 - fin) * lp + scores.reshape(-1, 1)
    vals, idx = torch.sort(total, dim=-1, descending=True, stable=True)
    return vals[:, :topk].contiguous(), idx[:, :topk].to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
LIBRARY = "fused_decoder"   # the build of csrc/fused_decoder.cu the wrappers launch


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(LIBRARY)
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "fd_linear": [P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, P],
        "fd_add_layernorm": [P, P, P, P, P, P, I, I, I, I, Fl, P],
        "fd_self_attention": [P, P, P, P, P, P, I, I, I, I, I, Fl, I, P],
        "fd_cross_attention": [P, P, P, P, I, I, I, I, I, Fl, I, P],
        "fd_logsoftmax_topk": [P, P, P, P, P, I, I, I, P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    lib.fd_error_string.argtypes, lib.fd_error_string.restype = [I], ctypes.c_char_p
    return lib


def _compute_dtype(name: str, t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: kernels take float32 or bfloat16, not {t.dtype}")
    return _DTYPE_CODE[t.dtype]


def _error_string(rc: int) -> bytes:
    return _lib().fd_error_string(rc)


class LinearPlan(NamedTuple):
    """How ``decoder_linear``'s wgmma kernel covers an (M, K) × (K, N)
    product: output tiles of ``bm`` × ``bn``, K split across a cluster of
    ``split`` CTAs; grid (split, grid_n, grid_m), ``kslices`` 64-deep K slices
    a CTA (split · kslices = ceil(K / 64))."""
    bm: int
    bn: int
    split: int
    grid_n: int
    grid_m: int
    kslices: int


@functools.lru_cache(maxsize=1024)
def linear_plan(m: int, n: int, k: int, sms: int = H100_SMS, bm: int | None = None,
                split: int | None = None) -> LinearPlan:
    """The tile and split plan of the wgmma kernel. Tiles of 64 rows (one
    consumer warpgroup), or of 128 rows (two, sharing each W slice) where
    64-row tiles would outnumber the SMs. K is split in powers of two across
    a cluster (at most 8 CTAs, each a whole number of 64-deep slices) while
    the CTAs stay within 3/4 of the SMs, or within all of them where each
    CTA still walks ``SPLIT_DEEP`` slices or more: a split's cluster barriers
    and exchange cost ~1.3 µs, which a short K repays only while few CTAs
    share the card (PERF.md). ``bm`` (64 or 128) and ``split`` force a
    plan, for tests and measurements."""
    slices, grid_n = -(-k // LINEAR_BK), -(-n // LINEAR_BN)
    if bm is None:
        bm = 128 if m > 64 and grid_n * -(-m // 64) > sms else 64
    if bm not in (64, 128):
        raise ValueError(f"linear_plan: bm must be 64 or 128, not {bm}")
    grid_m = -(-m // bm)
    if split is None:
        split = 1
        while 2 * split <= MAX_CLUSTER and slices % (2 * split) == 0:
            ctas = grid_n * grid_m * 2 * split
            if ctas > sms or (ctas > 3 * sms // 4 and slices // (2 * split) < SPLIT_DEEP):
                break
            split *= 2
    if split not in (1, 2, 4, 8) or slices % split:
        raise ValueError(f"linear_plan: split {split} is not 1, 2, 4 or 8 dividing {slices} "
                         "K slices")
    return LinearPlan(bm, LINEAR_BN, split, grid_n, grid_m, slices // split)


@functools.cache
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_NO_PLAN = LinearPlan(0, 0, 0, 0, 0, 0)   # linear_kernel on the CUDA cores


def decoder_linear(x, w, b, act: str = "none", out_f32: bool = False,
                   plan: LinearPlan | None = None):
    """Kernel (a): ``act(x·w + b)`` — x (M, K), w (K, N) in x's dtype, b (N,)
    float32; result in x's dtype, or float32 with ``out_f32``. bf16 with K and
    N multiples of 8 runs the wgmma kernel on ``plan`` (default
    ``linear_plan(M, N, K)``; x and w must start on 16-byte boundaries);
    anything else the CUDA-core kernel."""
    if on_cpu(x):
        return decoder_linear_reference(x, w, b, act, out_f32)
    m, k = x.shape
    n = w.shape[1]
    code, dev = _compute_dtype("decoder_linear", x), x.get_device()
    check("x", x, (m, k), x.dtype, dev)
    check("w", w, (k, n), x.dtype, dev)
    check("b", b, (n,), torch.float32, dev)
    if code == 1 and k % 8 == 0 and n % 8 == 0:
        if (x.data_ptr() | w.data_ptr()) % 16:
            raise ValueError("decoder_linear: x and w must start on 16-byte boundaries")
        plan = plan or linear_plan(m, n, k, _sm_count(dev))
    elif plan is not None:
        raise ValueError("decoder_linear: a plan applies to bf16 with K and N multiples of 8")
    else:
        plan = _NO_PLAN
    y = x.new_empty((m, n), dtype=torch.float32 if out_f32 else x.dtype)
    rc = _lib().fd_linear(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), m, n, k,
                          code, int(out_f32), _ACT_CODE[act], plan.bm, plan.split, plan.grid_n,
                          plan.grid_m, plan.kslices, stream(dev))
    launched(decoder_linear, rc, _error_string)
    return y


def decoder_add_layernorm(y, r, gamma, beta, out_dtype):
    """Kernel (b): ``LN(y + r)`` — y (rows, d) float32, r (rows, d) in
    ``out_dtype`` or float32, gamma/beta (d,) float32. Returns the float32
    result and its cast to ``out_dtype`` (the same tensor at float32)."""
    if on_cpu(y):
        return decoder_add_layernorm_reference(y, r, gamma, beta, out_dtype)
    rows, d = y.shape
    code = _DTYPE_CODE.get(out_dtype)
    if code is None or r.dtype not in (out_dtype, torch.float32):
        raise TypeError(f"decoder_add_layernorm: unsupported dtypes r={r.dtype}, out={out_dtype}")
    dev = y.get_device()
    check("y", y, (rows, d), torch.float32, dev)
    check("r", r, (rows, d), r.dtype, dev)
    check("gamma", gamma, (d,), torch.float32, dev)
    check("beta", beta, (d,), torch.float32, dev)
    out_t = y.new_empty((rows, d), dtype=out_dtype)
    out_f = None if code == 0 else y.new_empty((rows, d))
    rc = _lib().fd_add_layernorm(
        y.data_ptr(), r.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if out_f is None else out_f.data_ptr(), out_t.data_ptr(), rows, d, code,
        int(r.dtype == torch.float32), LN_EPS, stream(dev))
    launched(decoder_add_layernorm, rc, _error_string)
    return (out_t if out_f is None else out_f), out_t


def _check_heads(d: int, num_heads: int) -> None:
    if num_heads < 1 or d % num_heads:
        raise ValueError(f"attention kernels need H >= 1 and d % H == 0 (d={d}, H={num_heads})")


def _scratch(x: torch.Tensor, d: int, num_heads: int) -> tuple[torch.Tensor | None, int | None]:
    """The wide path's float32 context rows (BK, d) and their address, for
    head widths above ``WIDE_HEAD_DIM`` (the caller holds the tensor through
    the launch); (None, None) otherwise."""
    if d // num_heads <= WIDE_HEAD_DIM:
        return None, None
    t = x.new_empty((x.shape[0], d), dtype=torch.float32)
    return t, t.data_ptr()


def decoder_self_attention(qkv, k_self, v_self, layer: int, pos: int, src_t, beam: int,
                           num_heads: int):
    """Kernel (c): self-attention of one position over the beam-ancestry cache.
    qkv (BK, 3d); k_self/v_self (N, Lpad, BK, d), row ``pos`` of ``layer``
    written IN PLACE; src_t (Lpad, BK) int32 group-local beam indices, which
    ``beam_search`` keeps in [0, beam). Returns the context (BK, d)."""
    if on_cpu(qkv):
        return decoder_self_attention_reference(
            qkv, k_self, v_self, layer, pos, src_t, beam, num_heads)
    bk, d3 = qkv.shape
    d = d3 // 3
    n, lpad = k_self.shape[:2]
    code, dev = _compute_dtype("decoder_self_attention", qkv), qkv.get_device()
    _check_heads(d, num_heads)
    if not (0 <= layer < n and 0 <= pos < lpad and bk % beam == 0):
        raise ValueError(f"bad layer/pos/beam: {layer}/{pos}/{beam} for cache {tuple(k_self.shape)}")
    check("qkv", qkv, (bk, 3 * d), qkv.dtype, dev)
    check("k_self", k_self, (n, lpad, bk, d), qkv.dtype, dev)
    check("v_self", v_self, (n, lpad, bk, d), qkv.dtype, dev)
    check("src_t", src_t, (lpad, bk), torch.int32, dev)
    ctx, (_scratch_rows, scratch) = qkv.new_empty((bk, d)), _scratch(qkv, d, num_heads)
    rc = _lib().fd_self_attention(
        qkv.data_ptr(), k_self[layer].data_ptr(), v_self[layer].data_ptr(), src_t.data_ptr(),
        ctx.data_ptr(), scratch, bk, d, num_heads, beam, pos, 1.0 / math.sqrt(d // num_heads),
        code, stream(dev))
    launched(decoder_self_attention, rc, _error_string)
    return ctx


def decoder_cross_attention(q, kv_cross, layer: int, beam: int, num_heads: int):
    """Kernel (d): cross-attention of q (BK, d) over kv_cross[layer]
    (Lenc, B, 2d), row r reading batch item r // beam. Returns (BK, d).
    Raises ValueError over an empty encoder output, on either device."""
    _check_lenc(kv_cross.shape[1])
    if on_cpu(q):
        return decoder_cross_attention_reference(q, kv_cross, layer, beam, num_heads)
    bk, d = q.shape
    n, lenc, b = kv_cross.shape[:3]
    code, dev = _compute_dtype("decoder_cross_attention", q), q.get_device()
    _check_heads(d, num_heads)
    if not (0 <= layer < n and bk == b * beam):
        raise ValueError(f"bad layer/beam: {layer}/{beam} for {bk} rows and cross K/V "
                         f"{tuple(kv_cross.shape)}")
    check("q", q, (bk, d), q.dtype, dev)
    check("kv_cross", kv_cross, (n, lenc, b, 2 * d), q.dtype, dev)
    ctx, (_scratch_rows, scratch) = q.new_empty((bk, d)), _scratch(q, d, num_heads)
    rc = _lib().fd_cross_attention(
        q.data_ptr(), kv_cross[layer].data_ptr(), ctx.data_ptr(), scratch, b, lenc, d,
        num_heads, beam, 1.0 / math.sqrt(d // num_heads), code, stream(dev))
    launched(decoder_cross_attention, rc, _error_string)
    return ctx


def decoder_logsoftmax_topk(logits, scores, finished, topk: int):
    """Kernel (e): logits (BK, V) float32, scores/finished (BK, 1) float32 →
    top ``topk`` (scores (BK, topk) float32, ids (BK, topk) int32), see
    ``decoder_logsoftmax_topk_reference``."""
    if on_cpu(logits):
        return decoder_logsoftmax_topk_reference(logits, scores, finished, topk)
    bk, v = logits.shape
    if not 0 < topk <= v:
        raise ValueError(f"decoder_logsoftmax_topk: topk={topk}, V={v} unsupported")
    scores, finished, dev = scores.reshape(-1), finished.reshape(-1), logits.get_device()
    check("logits", logits, (bk, v), torch.float32, dev)
    check("scores", scores, (bk,), torch.float32, dev)
    check("finished", finished, (bk,), torch.float32, dev)
    out_s = logits.new_empty((bk, topk))
    out_i = logits.new_empty((bk, topk), dtype=torch.int32)
    rc = _lib().fd_logsoftmax_topk(
        logits.data_ptr(), scores.data_ptr(), finished.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), bk, v, topk, stream(dev))
    launched(decoder_logsoftmax_topk, rc, _error_string)
    return out_s, out_i


KERNELS = (decoder_linear, decoder_add_layernorm, decoder_self_attention,
           decoder_cross_attention, decoder_logsoftmax_topk)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()

KERNEL_OPS = SimpleNamespace(
    linear=decoder_linear, add_layernorm=decoder_add_layernorm,
    self_attention=decoder_self_attention, cross_attention=decoder_cross_attention,
    logsoftmax_topk=decoder_logsoftmax_topk,
)
PLAIN_OPS = SimpleNamespace(
    linear=decoder_linear_reference, add_layernorm=decoder_add_layernorm_reference,
    self_attention=decoder_self_attention_reference,
    cross_attention=decoder_cross_attention_reference,
    logsoftmax_topk=decoder_logsoftmax_topk_reference,
)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def decode_step_with(ops, packed, cache, x_emb, src_t, pos, scores, finished, *,
                     num_layers, beam, num_heads, topk, activation):
    """The step's launches in order through ``ops`` (``KERNEL_OPS``,
    ``PLAIN_OPS``, or a probe's own five); returns ``(top_s, top_ids)``."""
    if activation not in FUSED_ACTIVATIONS:
        raise ValueError(f"fused decoder: unsupported activation {activation!r}")
    if num_layers != len(packed["layers"]):
        raise ValueError(f"num_layers={num_layers} but the weights pack {len(packed['layers'])}")
    dtype = packed["wqkv"].dtype
    k_self, v_self, kv_cross = cache["k_self"], cache["v_self"], cache["kv_cross"]
    x = x_emb.to(dtype)
    for l, p in enumerate(packed["layers"]):
        ln = p["ln"]
        qkv = ops.linear(x, p["wqkv"], p["bqkv"])
        ctx = ops.self_attention(qkv, k_self, v_self, l, pos, src_t, beam, num_heads)
        attn = ops.linear(ctx, p["wo"], p["bo"], out_f32=True)
        out1, out1_t = ops.add_layernorm(attn, x, ln[0], ln[1], dtype)
        q2 = ops.linear(out1_t, p["wcq"], p["bcq"])
        ctx2 = ops.cross_attention(q2, kv_cross, l, beam, num_heads)
        attn2 = ops.linear(ctx2, p["wco"], p["bco"], out_f32=True)
        out2, out2_t = ops.add_layernorm(attn2, out1, ln[2], ln[3], dtype)
        hdn = ops.linear(out2_t, p["w1"], p["b1"], act=activation)
        ffn = ops.linear(hdn, p["w2"], p["b2"], out_f32=True)
        _, x = ops.add_layernorm(ffn, out2, ln[4], ln[5], dtype)
    logits = ops.linear(x, packed["wf"], packed["bf"], out_f32=True)
    return ops.logsoftmax_topk(logits, scores, finished, topk if topk is not None else beam)


@torch.no_grad()
def fused_decode_step_reference(packed, cache, x_emb, src_t, pos: int, scores, finished, *,
                                num_layers: int, beam: int, num_heads: int,
                                topk: int | None = None, activation: str = "leaky_relu"):
    """The whole step from the plain versions (same arguments and results as
    ``fused_decode_step``)."""
    top_s, top_i = decode_step_with(
        PLAIN_OPS, packed, cache, x_emb, src_t, pos, scores, finished,
        num_layers=num_layers, beam=beam, num_heads=num_heads, topk=topk,
        activation=activation)
    return top_s, top_i, cache


@torch.no_grad()
def fused_decode_step(packed, cache, x_emb, src_t, pos: int, scores, finished, *,
                      num_layers: int, beam: int, num_heads: int,
                      topk: int | None = None, activation: str = "leaky_relu"):
    """All decoder layers + vocabulary projection + log-softmax + beam freeze
    + per-row top-k for position ``pos`` (a Python int).

    ``x_emb`` (BK, d): token embedding + positional encoding; ``src_t``
    (Lpad, BK) int32 group-local ancestry; ``scores``/``finished`` (BK, 1)
    float32. Returns ``(top_s (BK, topk) float32, top_ids (BK, topk) int32,
    cache)`` — the row's best (score + log-prob, vocab id) pairs, descending,
    ties to the lowest id; ``topk`` defaults to ``beam``. The cache's
    ``k_self``/``v_self`` are updated IN PLACE at ``pos``.

    Contract: ``src_t[pos]`` is each row's OWN beam index — the current
    position's K/V come from this step's projection, not from the cache;
    ``beam_search`` guarantees it. CUDA tensors run the hand-written kernels,
    CPU tensors ``fused_decode_step_reference``."""
    if on_cpu(x_emb):
        return fused_decode_step_reference(
            packed, cache, x_emb, src_t, pos, scores, finished, num_layers=num_layers,
            beam=beam, num_heads=num_heads, topk=topk, activation=activation)
    top_s, top_i = decode_step_with(
        KERNEL_OPS, packed, cache, x_emb, src_t, pos, scores, finished,
        num_layers=num_layers, beam=beam, num_heads=num_heads, topk=topk,
        activation=activation)
    return top_s, top_i, cache
