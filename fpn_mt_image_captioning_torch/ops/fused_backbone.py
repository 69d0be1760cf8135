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
in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..models.backbones.mobilenet_v2 import _BLOCK_CONFIG, _C3_GROUP, _C4_GROUP
from ..models.layers import normalize_images
from ._build import MAX_SMEM, check, launched, load_library, on_cpu, stream

__all__ = [
    "KERNELS", "pack_backbone_weights", "fused_ir_block", "fused_ir_block_reference",
    "fused_mobilenet_backbone", "supports_fused_backbone", "fused_encode",
    "packed_to", "reset_launch_counts", "tile_plan",
]

BN_EPS = 1e-3
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# kernel geometry (csrc/fused_backbone.cu): output tiles of th × 8 pixels,
# expanded channels in chunks of 32, up to 320 output channels per block
TILE_W, CHUNK, MAX_NJ = 8, 32, 10
_NJ_CHOICES = (1, 2, 3, 5, 10)


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


def tile_plan(cin: int, cout: int, stride: int) -> tuple[int, int]:
    """(tile height th, NJ) for the kernel: NJ·32 output channels per block,
    and the largest th in 8, 4, 2, 1 whose shared memory fits (the input
    patch and every staging buffer are float32). Raises if none fits."""
    nj = next((n for n in _NJ_CHOICES if 32 * n >= cout), MAX_NJ)
    cin4 = -(-cin // 4) * 4
    for th in (8, 4, 2, 1):
        p = ((th - 1) * stride + 3) * ((TILE_W - 1) * stride + 3)
        floats = p * cin4 + cin4 * CHUNK + p * CHUNK + th * TILE_W * CHUNK + CHUNK * 32 * nj
        if 4 * floats <= MAX_SMEM:
            return th, nj
    raise ValueError(f"fused_ir_block: a block with {cin} input channels does not fit "
                     "in shared memory")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("fused_backbone")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.fb_ir_block.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, P]
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
    th, nj = tile_plan(cin, cout, stride)
    ho, wo = h // stride, w // stride
    y = x.new_empty((b, ho, wo, cout))
    ptr = lambda k: blk[k].data_ptr() if k in blk else None
    rc = _lib().fb_ir_block(
        x.data_ptr(), ptr("w_exp"), ptr("b_exp"), ptr("w_dw"), ptr("b_dw"), ptr("w_proj"),
        ptr("b_proj"), y.data_ptr(), b, h, w, cin, cexp, cout, stride, int(residual),
        th, nj, _DTYPE_CODE[x.dtype], stream(dev))
    launched(fused_ir_block, rc, _error_string)
    return y


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
    (its plain version everywhere with ``plain``), the head a matmul."""
    block = fused_ir_block_reference if plain else fused_ir_block
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
