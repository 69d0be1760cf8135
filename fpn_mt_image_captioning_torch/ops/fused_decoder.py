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

import torch
import torch.nn.functional as F

from ._build import load_library

__all__ = [
    "FUSED_ACTIVATIONS", "KERNELS", "round_up", "pack_decoder_weights",
    "init_fused_cache", "fused_decode_step", "fused_decode_step_reference",
    "decoder_linear", "decoder_linear_reference",
    "decoder_add_layernorm", "decoder_add_layernorm_reference",
    "decoder_self_attention", "decoder_self_attention_reference",
    "decoder_cross_attention", "decoder_cross_attention_reference",
    "decoder_logsoftmax_topk", "decoder_logsoftmax_topk_reference",
    "reset_launch_counts",
]

# FFN activations the kernels implement (all of models/layers.py)
FUSED_ACTIVATIONS = frozenset({"leaky_relu", "relu", "relu6", "gelu"})
_ACT_CODE = {"none": 0, "leaky_relu": 1, "relu": 2, "relu6": 3, "gelu": 4}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
LN_EPS = 1e-6
MAX_HEAD_DIM = 128   # the attention kernels hold dh/32 values per lane in 4 registers


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
    (N, Lenc, B, 2d). ``enc_output`` is un-tiled (B, Lenc, d)."""
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


def decoder_cross_attention_reference(q, kv_cross, layer: int, beam: int, num_heads: int):
    """Attention of each row over its batch item's (row // beam) encoder K/V."""
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
@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("fused_decoder")
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        "fd_linear": [P, P, P, P, I, I, I, I, I, I, P],
        "fd_add_layernorm": [P, P, P, P, P, P, I, I, I, I, Fl, P],
        "fd_self_attention": [P, P, P, P, P, I, I, I, I, I, Fl, I, P],
        "fd_cross_attention": [P, P, P, I, I, I, I, I, I, Fl, I, P],
        "fd_logsoftmax_topk": [P, P, P, P, P, I, I, I, P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    lib.fd_error_string.argtypes, lib.fd_error_string.restype = [I], ctypes.c_char_p
    return lib


def _on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version); False for a CUDA
    tensor (launch the kernel); raises for any other device."""
    if t.is_cpu:
        return True
    if not t.is_cuda:
        raise ValueError(f"fused decoder kernels run on CUDA or CPU tensors, not {t.device}")
    return False


def _check(name: str, t: torch.Tensor, shape, dtype, device: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    CUDA device ``device``. (Runs on every launch: its fast path reads no
    ``torch.device`` object, which costs more than the rest together.)"""
    if not (t.dtype == dtype and t.shape == shape and t.get_device() == device
            and t.is_contiguous()):
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {tuple(shape)} on "
            f"cuda:{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ', not contiguous'}")


def _compute_dtype(name: str, t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: kernels take float32 or bfloat16, not {t.dtype}")
    return _DTYPE_CODE[t.dtype]


def _stream(device: int) -> int:
    """PyTorch's current stream on CUDA device ``device`` as a raw handle
    (the call Triton's launcher uses; no Stream object is built per launch)."""
    return torch._C._cuda_getCurrentRawStream(device)


def _launched(wrapper, rc: int) -> None:
    if rc != 0:
        msg = _lib().fd_error_string(rc).decode()
        raise RuntimeError(f"{wrapper.__name__}: CUDA error {rc} ({msg})")
    wrapper.launches += 1


def decoder_linear(x, w, b, act: str = "none", out_f32: bool = False):
    """Kernel (a): ``act(x·w + b)`` — x (M, K), w (K, N) in x's dtype, b (N,)
    float32; result in x's dtype, or float32 with ``out_f32``."""
    if _on_cpu(x):
        return decoder_linear_reference(x, w, b, act, out_f32)
    m, k = x.shape
    n = w.shape[1]
    code, dev = _compute_dtype("decoder_linear", x), x.get_device()
    _check("x", x, (m, k), x.dtype, dev)
    _check("w", w, (k, n), x.dtype, dev)
    _check("b", b, (n,), torch.float32, dev)
    y = x.new_empty((m, n), dtype=torch.float32 if out_f32 else x.dtype)
    rc = _lib().fd_linear(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), m, n, k,
                          code, int(out_f32), _ACT_CODE[act], _stream(dev))
    _launched(decoder_linear, rc)
    return y


def decoder_add_layernorm(y, r, gamma, beta, out_dtype):
    """Kernel (b): ``LN(y + r)`` — y (rows, d) float32, r (rows, d) in
    ``out_dtype`` or float32, gamma/beta (d,) float32. Returns the float32
    result and its cast to ``out_dtype`` (the same tensor at float32)."""
    if _on_cpu(y):
        return decoder_add_layernorm_reference(y, r, gamma, beta, out_dtype)
    rows, d = y.shape
    code = _DTYPE_CODE.get(out_dtype)
    if code is None or r.dtype not in (out_dtype, torch.float32):
        raise TypeError(f"decoder_add_layernorm: unsupported dtypes r={r.dtype}, out={out_dtype}")
    dev = y.get_device()
    _check("y", y, (rows, d), torch.float32, dev)
    _check("r", r, (rows, d), r.dtype, dev)
    _check("gamma", gamma, (d,), torch.float32, dev)
    _check("beta", beta, (d,), torch.float32, dev)
    out_t = y.new_empty((rows, d), dtype=out_dtype)
    out_f = None if code == 0 else y.new_empty((rows, d))
    rc = _lib().fd_add_layernorm(
        y.data_ptr(), r.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if out_f is None else out_f.data_ptr(), out_t.data_ptr(), rows, d, code,
        int(r.dtype == torch.float32), LN_EPS, _stream(dev))
    _launched(decoder_add_layernorm, rc)
    return (out_t if out_f is None else out_f), out_t


def _check_heads(d: int, num_heads: int) -> None:
    if d % num_heads or d // num_heads > MAX_HEAD_DIM or num_heads > 32:
        raise ValueError(f"attention kernels need d % H == 0, d/H <= {MAX_HEAD_DIM}, "
                         f"H <= 32 (d={d}, H={num_heads})")


def decoder_self_attention(qkv, k_self, v_self, layer: int, pos: int, src_t, beam: int,
                           num_heads: int):
    """Kernel (c): self-attention of one position over the beam-ancestry cache.
    qkv (BK, 3d); k_self/v_self (N, Lpad, BK, d), row ``pos`` of ``layer``
    written IN PLACE; src_t (Lpad, BK) int32 group-local beam indices, which
    ``beam_search`` keeps in [0, beam). Returns the context (BK, d)."""
    if _on_cpu(qkv):
        return decoder_self_attention_reference(
            qkv, k_self, v_self, layer, pos, src_t, beam, num_heads)
    bk, d3 = qkv.shape
    d = d3 // 3
    n, lpad = k_self.shape[:2]
    code, dev = _compute_dtype("decoder_self_attention", qkv), qkv.get_device()
    _check_heads(d, num_heads)
    if not (0 <= layer < n and 0 <= pos < lpad and bk % beam == 0):
        raise ValueError(f"bad layer/pos/beam: {layer}/{pos}/{beam} for cache {tuple(k_self.shape)}")
    _check("qkv", qkv, (bk, 3 * d), qkv.dtype, dev)
    _check("k_self", k_self, (n, lpad, bk, d), qkv.dtype, dev)
    _check("v_self", v_self, (n, lpad, bk, d), qkv.dtype, dev)
    _check("src_t", src_t, (lpad, bk), torch.int32, dev)
    ctx = qkv.new_empty((bk, d))
    rc = _lib().fd_self_attention(
        qkv.data_ptr(), k_self[layer].data_ptr(), v_self[layer].data_ptr(), src_t.data_ptr(),
        ctx.data_ptr(), bk, d, num_heads, beam, pos, 1.0 / math.sqrt(d // num_heads), code,
        _stream(dev))
    _launched(decoder_self_attention, rc)
    return ctx


def decoder_cross_attention(q, kv_cross, layer: int, beam: int, num_heads: int):
    """Kernel (d): cross-attention of q (BK, d) over kv_cross[layer]
    (Lenc, B, 2d), row r reading batch item r // beam. Returns (BK, d)."""
    if _on_cpu(q):
        return decoder_cross_attention_reference(q, kv_cross, layer, beam, num_heads)
    bk, d = q.shape
    n, lenc, b = kv_cross.shape[:3]
    code, dev = _compute_dtype("decoder_cross_attention", q), q.get_device()
    _check_heads(d, num_heads)
    if not (0 <= layer < n and bk == b * beam):
        raise ValueError(f"bad layer/beam: {layer}/{beam} for {bk} rows and cross K/V "
                         f"{tuple(kv_cross.shape)}")
    _check("q", q, (bk, d), q.dtype, dev)
    _check("kv_cross", kv_cross, (n, lenc, b, 2 * d), q.dtype, dev)
    ctx = q.new_empty((bk, d))
    rc = _lib().fd_cross_attention(
        q.data_ptr(), kv_cross[layer].data_ptr(), ctx.data_ptr(), bk, b, lenc, d, num_heads,
        beam, 1.0 / math.sqrt(d // num_heads), code, _stream(dev))
    _launched(decoder_cross_attention, rc)
    return ctx


_MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper


def decoder_logsoftmax_topk(logits, scores, finished, topk: int):
    """Kernel (e): logits (BK, V) float32, scores/finished (BK, 1) float32 →
    top ``topk`` (scores (BK, topk) float32, ids (BK, topk) int32), see
    ``decoder_logsoftmax_topk_reference``."""
    if _on_cpu(logits):
        return decoder_logsoftmax_topk_reference(logits, scores, finished, topk)
    bk, v = logits.shape
    if not 0 < topk <= v or v * 4 > _MAX_SMEM:
        raise ValueError(f"decoder_logsoftmax_topk: topk={topk}, V={v} unsupported")
    scores, finished, dev = scores.reshape(-1), finished.reshape(-1), logits.get_device()
    _check("logits", logits, (bk, v), torch.float32, dev)
    _check("scores", scores, (bk,), torch.float32, dev)
    _check("finished", finished, (bk,), torch.float32, dev)
    out_s = logits.new_empty((bk, topk))
    out_i = logits.new_empty((bk, topk), dtype=torch.int32)
    rc = _lib().fd_logsoftmax_topk(
        logits.data_ptr(), scores.data_ptr(), finished.data_ptr(), out_s.data_ptr(),
        out_i.data_ptr(), bk, v, topk, _stream(dev))
    _launched(decoder_logsoftmax_topk, rc)
    return out_s, out_i


KERNELS = (decoder_linear, decoder_add_layernorm, decoder_self_attention,
           decoder_cross_attention, decoder_logsoftmax_topk)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()

_KERNEL_OPS = SimpleNamespace(
    linear=decoder_linear, add_layernorm=decoder_add_layernorm,
    self_attention=decoder_self_attention, cross_attention=decoder_cross_attention,
    logsoftmax_topk=decoder_logsoftmax_topk,
)
_PLAIN_OPS = SimpleNamespace(
    linear=decoder_linear_reference, add_layernorm=decoder_add_layernorm_reference,
    self_attention=decoder_self_attention_reference,
    cross_attention=decoder_cross_attention_reference,
    logsoftmax_topk=decoder_logsoftmax_topk_reference,
)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------
def _decode_step(ops, packed, cache, x_emb, src_t, pos, scores, finished, *,
                 num_layers, beam, num_heads, topk, activation):
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
    top_s, top_i = _decode_step(
        _PLAIN_OPS, packed, cache, x_emb, src_t, pos, scores, finished,
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
    if _on_cpu(x_emb):
        return fused_decode_step_reference(
            packed, cache, x_emb, src_t, pos, scores, finished, num_layers=num_layers,
            beam=beam, num_heads=num_heads, topk=topk, activation=activation)
    top_s, top_i = _decode_step(
        _KERNEL_OPS, packed, cache, x_emb, src_t, pos, scores, finished,
        num_layers=num_layers, beam=beam, num_heads=num_heads, topk=topk,
        activation=activation)
    return top_s, top_i, cache
