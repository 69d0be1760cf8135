"""The fused MobileNetV2 backbone: each inverted-residual block as ONE kernel
with inference BatchNorm folded into its weights (port of
``fpn_mt_image_captioning_tpu/ops/fused_backbone.py``).

A block is expand 1×1 + bias + relu6 → depthwise 3×3 (stride 1 or 2, TF-SAME)
+ bias + relu6 → project 1×1 + bias (+ residual). Run as three cuDNN convs,
every expanded intermediate (up to 6× the block's input) goes through device
memory and back; ``fused_ir_block`` keeps it on chip, so device memory sees
only the block's input, weights and output.

Layout: plain NHWC ``(B, H, W, C)`` with the real channel counts. The TPU
kernel's bordered, 128-lane-padded layout was a Mosaic requirement and is not
carried over; the kernel (``csrc/fused_backbone.cu``) pads in shared memory
and picks the stride-2 columns itself.

Precision, as the TPU kernel has it: expand with float32 accumulation, bias
and clip in float32; the depthwise in float32 with float32 weights; its
result cast to the working dtype before the project; the project accumulated
in float32 plus bias, the residual (from the working-dtype input) added in
float32, then one cast.

``fused_ir_block`` takes its plain PyTorch version
(``fused_ir_block_reference``) when its input lies on the CPU, launches the
kernel on a CUDA tensor, and raises on anything else; it counts its launches
in ``.launches``. It is also a custom operator (``ops/operators.py``), the
node an exported program (``export.py``) holds for it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..models.backbones.mobilenet_v2 import _BLOCK_CONFIG, _C3_GROUP, _C4_GROUP
from ..models.layers import normalize_images
from ._build import MAX_SMEM, check, launched, load_library, on_cpu, stream
from .fused_decoder import H100_SMS

__all__ = [
    "KERNELS", "pack_backbone_weights", "fused_ir_block", "fused_ir_block_reference",
    "fused_mobilenet_backbone", "supports_fused_backbone", "fused_encode",
    "packed_to", "reset_launch_counts", "tile_plan", "TilePlan", "block_occupancy",
]

BN_EPS = 1e-3
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# kernel geometry (csrc/fused_backbone.cu): output tiles of th × 8 pixels,
# expanded channels in chunks of 32, 256 threads a block. float32 (CUDA
# cores): 32·NJ output channels a block. bfloat16 (tensor cores): a warp
# holds one m-tile of 16 output pixels × NTW n-tiles of 8 channels
TILE_W, CHUNK, THREADS = 8, 32, 256
_NJ_CHOICES = (1, 2, 3, 5, 10)
_NTW_CHOICES = (2, 4, 6, 10)
ROW_PAD = 8                   # bf16 of padding a shared row (ldmatrix banks)
SM_SMEM = 233472              # shared memory of one H100 SM, bytes
BLOCK_RESERVED = 1024         # shared memory the card reserves a block
# bfloat16 takes 16-row tiles only where the image still gives this many
# tiles an SM (each tile pays fixed costs; too few tiles leave SMs idle)
TALL_TILES_PER_SM = 4


# ---------------------------------------------------------------------------
# weight packing: fold inference BatchNorm into the conv weights
# ---------------------------------------------------------------------------
def _fold(conv_bn) -> tuple[torch.Tensor, torch.Tensor]:
    """(kernel', bias') of a ``_ConvBN`` with its BatchNorm folded in, in
    float32: kernel' = kernel · γ/√(var + ε), bias' = β − mean · γ/√(var + ε),
    ε 1e-3. The kernel keeps PyTorch's OIHW layout."""
    bn = conv_bn.bn
    k = conv_bn.conv.weight.detach().float()
    s = bn.weight.detach().float() * torch.rsqrt(bn.running_var.float() + BN_EPS)
    return k * s[:, None, None, None], bn.bias.detach().float() - bn.running_mean.float() * s


@torch.no_grad()
def pack_backbone_weights(backbone, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Fold the BatchNorms of a ``MobileNetV2Backbone`` (any alpha: channel
    counts come from the weights) into

      stem_k (C0, 3, 3, 3) OIHW ``dtype``, stem_b (C0,) float32;
      head_k (Cin, 1280) ``dtype``,        head_b (1280,) float32;
      blocks: per block ``(blk, meta)``, ``blk`` holding
        w_exp (Cin, Cexp) ``dtype`` and b_exp (Cexp,) float32 (absent for
        expansion-1 blocks), w_dw (9, Cexp) float32 (taps row-major
        ``dy*3+dx``), b_dw (Cexp,) float32, w_proj (Cexp, Cout) ``dtype``,
        b_proj (Cout,) float32; ``meta`` its stride, residual flag, c_out.

    Fold in float32 from float32 weights, then cast: pack before a model is
    cast to a narrower compute dtype."""
    blocks = []
    for gi, (t, _c, n, s) in enumerate(_BLOCK_CONFIG):
        for bi in range(n):
            mod = getattr(backbone, f"block_{gi}_{bi}")
            blk = {}
            wd, bd = _fold(mod.depthwise)                     # (Cexp, 1, 3, 3)
            cexp = wd.shape[0]
            wp, bp = _fold(mod.project)                       # (Cout, Cexp, 1, 1)
            if t != 1:
                we, be = _fold(mod.expand)                    # (Cexp, Cin, 1, 1)
                blk["w_exp"] = we[:, :, 0, 0].t().to(dtype).contiguous()
                blk["b_exp"] = be.contiguous()
            blk["w_dw"] = wd.reshape(cexp, 9).t().contiguous()
            blk["b_dw"] = bd.contiguous()
            blk["w_proj"] = wp[:, :, 0, 0].t().to(dtype).contiguous()
            blk["b_proj"] = bp.contiguous()
            stride = s if bi == 0 else 1
            meta = {"stride": stride, "residual": mod.residual, "c_out": wp.shape[0]}
            blocks.append((blk, meta))
    ws, bs = _fold(backbone.stem)
    wh, bh = _fold(backbone.head)
    return {
        "stem_k": ws.to(dtype).contiguous(), "stem_b": bs.contiguous(),
        "head_k": wh[:, :, 0, 0].t().to(dtype).contiguous(), "head_b": bh.contiguous(),
        "blocks": blocks,
    }


def packed_to(packed: dict, device) -> dict:
    """``packed`` with every tensor moved to ``device``."""
    mv = lambda d: {k: v.to(device) for k, v in d.items()}
    return {**mv({k: v for k, v in packed.items() if k != "blocks"}),
            "blocks": [(mv(blk), meta) for blk, meta in packed["blocks"]]}


# ---------------------------------------------------------------------------
# one block: plain version and kernel wrapper
# ---------------------------------------------------------------------------
def _check_extents(x: torch.Tensor, stride: int) -> None:
    h, w = x.shape[1:3]
    if stride == 2 and (h % 2 or w % 2):
        # TF SAME at stride 2 on an odd extent pads 1/1, not 0/1; neither the
        # kernel nor the plain version implement that, and both refuse it
        # rather than diverge from the eager backbone
        raise ValueError(
            f"fused backbone requires even extents at stride-2 blocks, got {h}x{w}; "
            "use an image_input_size divisible by 32")


def fused_ir_block_reference(x: torch.Tensor, blk: dict, *, stride: int,
                             residual: bool) -> torch.Tensor:
    """One inverted-residual block on NHWC ``x`` (B, H, W, Cin) in the working
    dtype, with the kernel's precision (module docstring). Returns (B, Ho, Wo,
    Cout), Ho = H / stride."""
    _check_extents(x, stride)
    f32 = torch.float32
    if "w_exp" in blk:
        h = torch.clamp(x.to(f32) @ blk["w_exp"].to(f32) + blk["b_exp"], 0.0, 6.0)
    else:
        h = x.to(f32)
    # SAME padding of the EXPANDED activation with zeros: stride 1 pads 1/1,
    # stride 2 on an even extent 0 before and 1 after
    pad = (0, 0, 1, 1, 1, 1) if stride == 1 else (0, 0, 0, 1, 0, 1)
    hp = F.pad(h, pad)
    ho, wo = x.shape[1] // stride, x.shape[2] // stride
    acc = blk["b_dw"].expand(x.shape[0], ho, wo, -1).clone()
    for dy in range(3):
        for dx in range(3):
            tap = hp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            acc += blk["w_dw"][dy * 3 + dx] * tap
    d = torch.clamp(acc, 0.0, 6.0).to(x.dtype)
    out = d.to(f32) @ blk["w_proj"].to(f32) + blk["b_proj"]
    if residual:
        out = out + x.to(f32)
    return out.to(x.dtype)


class TilePlan(NamedTuple):
    """How ``fused_ir_block``'s kernel covers a block: output tiles of ``th``
    × 8 pixels; ``unit`` NJ (float32) or NTW (bfloat16); ``width`` output
    channels a block, ``slices`` blocks across Cout; ``smem`` bytes of
    dynamic shared memory a block and the blocks an SM that leaves room
    for (the bfloat16 kernel's registers allow two: ``__launch_bounds__(256,
    2)``)."""
    th: int
    unit: int
    width: int
    slices: int
    smem: int
    blocks_per_sm: int


def _plan(th, unit, width, cout, smem) -> TilePlan:
    return TilePlan(th, unit, width, -(-cout // width), smem,
                    SM_SMEM // (smem + BLOCK_RESERVED))


def _mma_smem(th: int, stride: int, cin: int, ntw: int, expand: bool) -> tuple[int, int]:
    """(bytes, width) of the bfloat16 kernel's block (``mma_smem_bytes``):
    the bf16 patch (K padded to 16), the chunk's expand weights and float32
    expanded chunk (expand blocks), the bf16 depthwise output (16 rows at
    least), the chunk's project weights."""
    p = ((th - 1) * stride + 3) * ((TILE_W - 1) * stride + 3)
    k16 = -(-cin // 16) * 16
    to = th * TILE_W
    width = THREADS // 32 // -(-to // 16) * ntw * 8
    ld = CHUNK + ROW_PAD
    smem = (2 * p * (k16 + ROW_PAD) + (2 * k16 * ld + 4 * p * ld if expand else 0)
            + 2 * max(to, 16) * ld + 2 * CHUNK * (width + ROW_PAD))
    return smem, width


@functools.lru_cache(maxsize=None)
def tile_plan(cin: int, cout: int, stride: int, dtype: torch.dtype = torch.bfloat16,
              expand: bool = True, pixels: int = 0) -> TilePlan:
    """The kernel's plan for a block of ``pixels`` output pixels (batch ×
    Ho × Wo; ``csrc/fused_backbone.cu`` sums the same shared memory).
    bfloat16: the largest th in 16, 8, 4, 2, 1 whose project accumulators
    (NTW <= 10 n-tiles a warp) cover Cout in one slice and whose shared
    memory leaves room for two blocks an SM, 16 only where the pixels give
    ``TALL_TILES_PER_SM`` tiles an SM; failing that, the first plan with two
    blocks an SM, or that fits at all. float32: NJ·32 >= Cout
    (up to 320 a slice) and the largest th whose float32 staging fits. Raises
    if nothing fits."""
    if dtype == torch.float32:
        nj = next((n for n in _NJ_CHOICES if 32 * n >= cout), _NJ_CHOICES[-1])
        cin4 = -(-cin // 4) * 4
        for th in (8, 4, 2, 1):
            p = ((th - 1) * stride + 3) * ((TILE_W - 1) * stride + 3)
            floats = p * cin4 + cin4 * CHUNK + p * CHUNK + th * TILE_W * CHUNK + CHUNK * 32 * nj
            if 4 * floats <= MAX_SMEM:
                return _plan(th, nj, 32 * nj, cout, 4 * floats)
    else:
        plans = []
        tall = pixels >= 16 * TILE_W * TALL_TILES_PER_SM * H100_SMS
        for th in ((16,) if tall else ()) + (8, 4, 2, 1):
            warps_n = THREADS // 32 // -(-th * TILE_W // 16)
            need = -(-(-(-cout // 8)) // warps_n)
            ntw = next((n for n in _NTW_CHOICES if n >= need), _NTW_CHOICES[-1])
            smem, width = _mma_smem(th, stride, cin, ntw, expand)
            if smem <= MAX_SMEM:
                plans.append(_plan(th, ntw, width, cout, smem))
        for ok in (lambda q: q.slices == 1 and q.blocks_per_sm >= 2,
                   lambda q: q.blocks_per_sm >= 2, lambda q: True):
            chosen = next((q for q in plans if ok(q)), None)
            if chosen:
                return chosen
    raise ValueError(f"fused_ir_block: a block with {cin} input channels does not fit "
                     "in shared memory")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("fused_backbone")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fb_ir_block.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, P, P]
    lib.fb_ir_block.restype = I
    lib.fb_error_string.argtypes, lib.fb_error_string.restype = [I], ctypes.c_char_p
    return lib


def _error_string(rc: int) -> bytes:
    return _lib().fb_error_string(rc)


def fused_ir_block(x: torch.Tensor, blk: dict, *, stride: int, residual: bool) -> torch.Tensor:
    """One inverted-residual block (see ``fused_ir_block_reference``): the
    hand-written kernel on a CUDA tensor, the plain version on a CPU one."""
    if on_cpu(x):
        return fused_ir_block_reference(x, blk, stride=stride, residual=residual)
    _check_extents(x, stride)
    if stride not in (1, 2):
        raise ValueError(f"fused_ir_block: stride {stride}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_ir_block: the kernel takes float32 or bfloat16, not {x.dtype}")
    b, h, w, cin = x.shape
    has_expand = "w_exp" in blk
    cexp = blk["w_dw"].shape[1]
    cout = blk["w_proj"].shape[1]
    dev, f32 = x.get_device(), torch.float32
    check("x", x, (b, h, w, cin), x.dtype, dev)
    if has_expand:
        check("w_exp", blk["w_exp"], (cin, cexp), x.dtype, dev)
        check("b_exp", blk["b_exp"], (cexp,), f32, dev)
    elif cexp != cin:
        raise ValueError(f"fused_ir_block: no expand, but {cin} input and {cexp} depthwise "
                         "channels")
    check("w_dw", blk["w_dw"], (9, cexp), f32, dev)
    check("b_dw", blk["b_dw"], (cexp,), f32, dev)
    check("w_proj", blk["w_proj"], (cexp, cout), x.dtype, dev)
    check("b_proj", blk["b_proj"], (cout,), f32, dev)
    if residual and (stride != 1 or cin != cout):
        raise ValueError("fused_ir_block: a residual needs stride 1 and Cin == Cout")
    ho, wo = h // stride, w // stride
    plan = tile_plan(cin, cout, stride, x.dtype, has_expand, b * ho * wo)
    y = x.new_empty((b, ho, wo, cout))
    ptr = lambda k: blk[k].data_ptr() if k in blk else None
    rc = _lib().fb_ir_block(
        x.data_ptr(), ptr("w_exp"), ptr("b_exp"), ptr("w_dw"), ptr("b_dw"), ptr("w_proj"),
        ptr("b_proj"), y.data_ptr(), b, h, w, cin, cexp, cout, stride, int(residual),
        plan.th, plan.unit, _DTYPE_CODE[x.dtype], stream(dev), None)
    launched(fused_ir_block, rc, _error_string)
    return y


def block_occupancy(cin: int, cout: int, stride: int, dtype: torch.dtype,
                    expand: bool = True, pixels: int = 0) -> int:
    """Blocks an SM that ``fused_ir_block``'s kernel reaches on the current
    card for this block's plan (the CUDA occupancy calculator: registers and
    shared memory together). Launches nothing."""
    plan = tile_plan(cin, cout, stride, dtype, expand, pixels)
    n = ctypes.c_int(0)
    cexp = 6 * cin if expand else cin
    rc = _lib().fb_ir_block(None, 1 if expand else None, None, None, None, None, None, None, 1,
                            2, 2, cin, cexp, cout, stride, 0, plan.th, plan.unit,
                            _DTYPE_CODE[dtype], None, ctypes.addressof(n))
    if rc:
        raise RuntimeError(f"block_occupancy: {_error_string(rc).decode()} (code {rc})")
    return n.value


KERNELS = (fused_ir_block,)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()


# ---------------------------------------------------------------------------
# the whole backbone and the serving encode
# ---------------------------------------------------------------------------
def fused_mobilenet_backbone(packed: dict, images: torch.Tensor, *, plain: bool = False):
    """MobileNetV2 on folded weights: NHWC images (B, S, S, 3) in [-1, 1] →
    NHWC taps (C3, C4, C5), as ``MobileNetV2Backbone`` gives them in eval mode
    (there NCHW). The stem is a cuDNN conv, the 17 blocks ``fused_ir_block``
    (its plain version everywhere with ``plain``; its custom operator on the
    CPU and under ``torch.export``), the head a matmul."""
    if plain:
        block = fused_ir_block_reference
    elif torch.compiler.is_compiling() or on_cpu(images):
        from .operators import ir_block_via_op as block
    else:
        block = fused_ir_block
    dtype = packed["stem_k"].dtype
    x = F.pad(images.to(dtype).permute(0, 3, 1, 2), (0, 1, 0, 1))   # SAME, stride 2
    x = F.conv2d(x, packed["stem_k"], stride=2).permute(0, 2, 3, 1)
    x = torch.clamp(x.float() + packed["stem_b"], 0.0, 6.0).to(dtype).contiguous()
    taps = {}
    bi = 0
    for gi, (_t, _c, n, _s) in enumerate(_BLOCK_CONFIG):
        for _ in range(n):
            blk, meta = packed["blocks"][bi]
            bi += 1
            x = block(x, blk, stride=meta["stride"], residual=meta["residual"])
        taps[gi] = x
    c5 = x.float() @ packed["head_k"].float()
    c5 = torch.clamp(c5 + packed["head_b"], 0.0, 6.0).to(dtype)
    return taps[_C3_GROUP], taps[_C4_GROUP], c5


def supports_fused_backbone(backbone_name: str) -> bool:
    return backbone_name.startswith("mobilenet")


def fused_encode(model, packed: dict, images: torch.Tensor):
    """The serving encode with the fused backbone: (B, S, S, 3) uint8 or
    [-1, 1] float images → (B, Lenc, d_model), through
    ``Transformer.encode_from_taps`` for the FPN, heads and encoder."""
    c3, c4, c5 = fused_mobilenet_backbone(packed, normalize_images(images))
    return model.encode_from_taps(c3, c4, c5)
