"""Kernels of the port's measurement probes and their plain PyTorch
versions. The probes themselves are the scripts in
``fpn_mt_image_captioning_torch/scripts/``; they are the counterparts of the
TPU probes ``scripts/probe_launch_overhead.py``,
``scripts/probe_pallas_overhead.py`` and ``scripts/probe_grid_cell.py``.

  ``add_one``, ``add_one_grid7``   y = x + 1 in one launch; the second as the
                                   TPU's grid of 7 cells, cell 0 working
                                   (``csrc/probes.cu``)
  ``probe_step``                   the decode step's 68 launches through
                                   ``ops/fused_decoder.py``'s own wrappers
                                   and entry points, on the build of
                                   ``csrc/fused_decoder.cu`` whose kernels
                                   have empty bodies (``TRIVIAL_DECODER``)
  ``slab_copy_*`` (six)            rows 1 … rows·n_tiles of every item of x
                                   (B, Hp, Wp, C) bf16 doubled through
                                   shared memory: TMA on the four TPU layouts
                                   (4d, 3d, lane128, flat), and on the flat
                                   layout plain loads and cp.async
                                   (``csrc/probes.cu``)

Each wrapper takes its plain version (``*_reference``) when the tensor it is
given lies on the CPU, launches the kernel on a CUDA tensor, and raises on
anything else or on a failed launch or tensor-map encode; each counts its
launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import importlib.util
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from ..models.transformer import Decoder
from . import fused_decoder as fd
from ._build import MAX_SMEM, check, launched, load_library, on_cpu, stream

__all__ = [
    "KERNELS", "reset_launch_counts", "add_one", "add_one_grid7", "add_one_reference",
    "TRIVIAL_DECODER", "step_setup", "probe_step", "probe_step_reference",
    "SLAB_LAYOUTS", "slab_plan", "flat_chunk_bytes", "slab_copy_4d", "slab_copy_3d",
    "slab_copy_lane128", "slab_copy_flat", "slab_copy_flat_loads", "slab_copy_flat_cp_async",
    "slab_copy_reference", "slab_rows",
]

STAGE_BYTES = 72 * 1024   # one stage of a slab copy: a chunk of about 4 flagship rows
LANES = 128               # the TPU variant C's padded channel count
BOX_MAX = 256             # TMA: elements a box may span in one dimension


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("probes")
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "pr_add_one": [P, P, I, P],
        "pr_add_one_grid7": [P, P, I, P],
        "pr_slab_tma": [P, P, I, I, I, P, P],
        "pr_slab_flat": [P, P, I, I, I, P, I, P],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    lib.pr_error_string.argtypes, lib.pr_error_string.restype = [I], ctypes.c_char_p
    return lib


def _error_string(rc: int) -> bytes:
    return _lib().pr_error_string(rc)


# ---------------------------------------------------------------------------
# (3a, 4) x + 1
# ---------------------------------------------------------------------------
def add_one_reference(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def _add_one(wrapper, entry: str, x: torch.Tensor) -> torch.Tensor:
    if on_cpu(x):
        return add_one_reference(x)
    check("x", x, x.shape, torch.float32, x.get_device())
    y = torch.empty_like(x)
    rc = getattr(_lib(), entry)(x.data_ptr(), y.data_ptr(), x.numel(), stream(x.get_device()))
    launched(wrapper, rc, _error_string)
    return y


def add_one(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` of a contiguous float32 tensor, one launch."""
    return _add_one(add_one, "pr_add_one", x)


def add_one_grid7(x: torch.Tensor) -> torch.Tensor:
    """``x + 1`` as the TPU's ``grid=(7,)`` kernel: 7 blocks, block 0 works."""
    return _add_one(add_one_grid7, "pr_add_one_grid7", x)


# ---------------------------------------------------------------------------
# (3c) the decoder-shaped step: the port's own decode step, its kernels built
# with empty bodies
# ---------------------------------------------------------------------------
def _trivial_decoder():
    """A second instance of ``ops/fused_decoder.py`` whose wrappers launch the
    ``fused_decoder_trivial`` build of ``csrc/fused_decoder.cu`` (kernels
    with empty bodies): the decode step's own checks, allocations, entry
    points, grids and blocks, with no work on the card. Its wrappers are
    named ``<kernel>_trivial`` and keep their own launch counts."""
    spec = importlib.util.find_spec(fd.__name__)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.LIBRARY = "fused_decoder_trivial"
    for k in mod.KERNELS:
        k.__name__ = k.__qualname__ = f"{k.__name__}_trivial"
    return mod


TRIVIAL_DECODER = _trivial_decoder()


def probe_step_reference(scores: torch.Tensor, topk: int) -> torch.Tensor:
    """The step's one result: each row's running score in all ``topk``
    columns, float32 (what the trivial top-k kernel writes; the TPU probe's
    ``tops = x[:, :128]`` was likewise a copy of an input)."""
    return scores.reshape(-1, 1).repeat(1, topk)


def _step_ops(oh, compute_dots: int):
    """The five kinds the step launches: the trivial build's wrappers; with
    ``oh`` the self-attention wrapper also checks that operand (the TPU
    probe's one-hot, which the port does not have); with ``compute_dots``
    each FFN's first linear is followed by that many real ``decoder_linear``
    launches of its shape."""
    td = TRIVIAL_DECODER
    if oh is None and not compute_dots:
        return td.KERNEL_OPS
    ops = SimpleNamespace(**vars(td.KERNEL_OPS))
    if oh is not None:
        def self_attention(qkv, *args, attend=td.decoder_self_attention):
            check("oh", oh, oh.shape, qkv.dtype, qkv.get_device())
            return attend(qkv, *args)

        ops.self_attention = self_attention
    if compute_dots:
        def linear(x, w, b, act="none", out_f32=False, trivial=td.decoder_linear):
            y = trivial(x, w, b, act, out_f32)
            if act != "none":
                for _ in range(compute_dots):
                    fd.decoder_linear(x, w, b, act)
            return y

        ops.linear = linear
    return ops


def step_setup(*, b_items: int, beam: int, d: int, num_heads: int, dff: int, vocab: int,
               num_layers: int, lpad: int, lenc: int, with_oh: bool = True, tile: int = 128,
               compute_dots: int = 0, seed: int = 0, device="cuda") -> dict:
    """Operands of one decode step: a seeded decoder's weights packed by
    ``pack_decoder_weights`` (bf16), the ``init_fused_cache`` of a zero
    encoder output (b_items, lenc, d), a zero input (BK, d) bf16, zero
    ancestry, zero running scores (BK, 1) float32 (the step's result copies
    them; the TPU probe ran on zeros too) and finished flags; with
    ``with_oh`` the TPU's one-hot operand (4, lpad, tile, tile) bf16; and
    the kinds ``probe_step`` launches."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = SimpleNamespace(decoder=Decoder(num_layers, d, num_heads, dff, vocab),
                                num_layers=num_layers, final_layer=nn.Linear(d, vocab))
    model.decoder.to(device)
    model.final_layer.to(device)
    packed = fd.pack_decoder_weights(model, torch.bfloat16)
    bk = b_items * beam
    enc = torch.zeros((b_items, lenc, d), device=device)
    oh = torch.zeros((4, lpad, tile, tile), dtype=torch.bfloat16, device=device) if with_oh else None
    return {"packed": packed, "cache": fd.init_fused_cache(packed, enc, beam, lpad - 1),
            "x": torch.zeros((bk, d), dtype=torch.bfloat16, device=device),
            "src_t": torch.zeros((fd.round_up(lpad, 8), bk), dtype=torch.int32, device=device),
            "scores": torch.zeros((bk, 1), device=device),
            "finished": torch.zeros((bk, 1), device=device),
            "oh": oh, "ops": _step_ops(oh, compute_dots), "beam": beam,
            "num_heads": num_heads, "num_layers": num_layers}


@torch.no_grad()
def probe_step(s: dict, pos: int = 0) -> torch.Tensor:
    """One decode step of ``step_setup``'s operands through
    ``decode_step_with``, as ``fused_decode_step`` runs it, on the trivial
    build (11 launches a layer, then the vocabulary linear and the top-k: 68
    at 6 layers, plus the real linears of ``compute_dots``). Returns the
    top-k scores, ``probe_step_reference(scores, beam)``; on the CPU that
    plain version itself."""
    if on_cpu(s["x"]):
        return probe_step_reference(s["scores"], s["beam"])
    top_s, _ = TRIVIAL_DECODER.decode_step_with(
        s["ops"], s["packed"], s["cache"], s["x"], s["src_t"], pos, s["scores"], s["finished"],
        num_layers=s["num_layers"], beam=s["beam"], num_heads=s["num_heads"], topk=None,
        activation="leaky_relu")
    return top_s


# ---------------------------------------------------------------------------
# (5) the slab copy
# ---------------------------------------------------------------------------
SLAB_LAYOUTS = {"A": 0, "B": 1, "C": 2, "D": 3}


def slab_plan(layout: str, hp: int, wp: int, c: int, rows: int) -> dict:
    """How ``slab_tma_kernel`` walks a slab of ``rows`` rows of (wp, c) bf16
    (``c`` = 128 for layout C): per chunk ``nbox`` TMA boxes, for A-C
    ``chunk`` rows by ``box_w`` columns each (two boxes for Wp > 256), for D
    ``chunk`` flat pixels each; ``nchunks`` chunks of at most STAGE_BYTES
    (or one row, where a row is larger), two stages of shared memory
    (``smem`` bytes). Raises if two stages do not fit in a block's shared
    memory."""
    esz = 2
    if layout == "D":
        slab = rows * wp
        box = min(BOX_MAX, slab)
        nbox = max(1, min(STAGE_BYTES // (box * c * esz), slab // box))
        chunk, box_w = box, 0
        box_bytes = box * c * esz
        nchunks = -(-slab // (nbox * box))
    elif layout in SLAB_LAYOUTS:
        nbox = -(-wp // BOX_MAX)
        box_w = -(-wp // nbox)
        chunk = min(rows, BOX_MAX, max(1, STAGE_BYTES // (nbox * box_w * c * esz)))
        box_bytes = c * esz * box_w * chunk
        nchunks = -(-rows // chunk)
    else:
        raise ValueError(f"slab copy: layout {layout!r}, not one of {sorted(SLAB_LAYOUTS)}")
    slot = -(-box_bytes // 128) * 128
    smem = 2 * nbox * slot + 16 + 128
    if smem > MAX_SMEM:
        raise ValueError(f"slab copy: two stages of {nbox} boxes of {box_bytes} bytes exceed "
                         f"a block's shared memory")
    return dict(hp=hp, wp=wp, rows=rows, chunk=chunk, nbox=nbox, box_w=box_w, nchunks=nchunks,
                box_bytes=box_bytes, slot_bytes=slot, smem=smem)


def flat_chunk_bytes(rows: int, wp: int, c: int) -> int:
    """Bytes of a chunk of the flat loads / cp.async copies (one stage of at
    most STAGE_BYTES, 16-byte vectors). Raises unless every row starts on
    16 bytes."""
    if (wp * c * 2) % 16:
        raise ValueError(f"slab copy: rows of {wp}×{c} bf16 do not start on 16 bytes")
    return min(STAGE_BYTES, rows * wp * c * 2) // 16 * 16


def _out_shape(layout: str, b: int, hp: int, wp: int, c: int) -> tuple:
    return {"A": (b, hp, wp, c), "B": (b * hp, wp, c), "C": (b, hp, wp, LANES),
            "D": (b * hp * wp, c)}[layout]


def _check_slab(x: torch.Tensor, rows: int, n_tiles: int) -> None:
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"slab copy: x must be (B, Hp, Wp, C) bf16, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if rows < 1 or n_tiles < 1 or 1 + rows * n_tiles > x.shape[1]:
        raise ValueError(f"slab copy: {n_tiles} slabs of {rows} rows from row 1 do not fit "
                         f"in Hp={x.shape[1]}")


def slab_copy_reference(x: torch.Tensor, layout: str, rows: int, n_tiles: int) -> torch.Tensor:
    """Rows 1 … rows·n_tiles of every item of x doubled, in layout
    ``layout``'s output shape; the other rows are left unwritten (layout C
    pads the channels to 128 with zeros first, as ``jnp.pad`` did)."""
    _check_slab(x, rows, n_tiles)
    b, hp, wp, c = x.shape
    src = F.pad(x, (0, LANES - c)) if layout == "C" else x
    y = torch.empty_like(src)
    r = slice(1, 1 + rows * n_tiles)
    y[:, r] = src[:, r] * 2
    return y.reshape(_out_shape(layout, b, hp, wp, c))


def slab_rows(y: torch.Tensor, x_shape, rows: int, n_tiles: int) -> torch.Tensor:
    """The written rows of a slab copy's output ``y`` of input shape
    ``x_shape``, as (B, rows·n_tiles, Wp, C or 128)."""
    b, hp, wp, _ = x_shape
    return y.reshape(b, hp, wp, -1)[:, 1:1 + rows * n_tiles]


def _slab_tma(wrapper, layout: str, x: torch.Tensor, rows: int, n_tiles: int):
    if on_cpu(x):
        return slab_copy_reference(x, layout, rows, n_tiles)
    _check_slab(x, rows, n_tiles)
    b, hp, wp, c = x.shape
    dev = x.get_device()
    check("x", x, (b, hp, wp, c), torch.bfloat16, dev)
    if layout == "C":
        if c > LANES:
            raise ValueError(f"slab copy C: {c} channels exceed {LANES}")
        x = F.pad(x, (0, LANES - c))
    y = torch.empty_like(x)
    plan = slab_plan(layout, hp, wp, x.shape[3], rows)
    geom = (ctypes.c_int * 10)(hp, wp, rows, n_tiles, plan["chunk"], plan["nbox"], plan["box_w"],
                               plan["nchunks"], plan["box_bytes"], plan["slot_bytes"])
    rc = _lib().pr_slab_tma(x.data_ptr(), y.data_ptr(), SLAB_LAYOUTS[layout], b, x.shape[3],
                            geom, stream(dev))
    launched(wrapper, rc, _error_string)
    return y.reshape(_out_shape(layout, b, hp, wp, c))


def slab_copy_4d(x, rows: int, n_tiles: int):
    """TPU variant A: TMA over the rank-4 (C, Wp, Hp, B) map; (B, Hp, Wp, C)."""
    return _slab_tma(slab_copy_4d, "A", x, rows, n_tiles)


def slab_copy_3d(x, rows: int, n_tiles: int):
    """TPU variant B: TMA over the rank-3 (C, Wp, B·Hp) map; (B·Hp, Wp, C)."""
    return _slab_tma(slab_copy_3d, "B", x, rows, n_tiles)


def slab_copy_lane128(x, rows: int, n_tiles: int):
    """TPU variant C: x padded to 128 channels in the call, then TMA over the
    rank-4 map of the copy; (B, Hp, Wp, 128)."""
    return _slab_tma(slab_copy_lane128, "C", x, rows, n_tiles)


def slab_copy_flat(x, rows: int, n_tiles: int):
    """TPU variant D: TMA over the rank-2 (C, B·Hp·Wp) map; (B·Hp·Wp, C)."""
    return _slab_tma(slab_copy_flat, "D", x, rows, n_tiles)


def _slab_flat(wrapper, mechanism: int, x: torch.Tensor, rows: int, n_tiles: int):
    if on_cpu(x):
        return slab_copy_reference(x, "D", rows, n_tiles)
    _check_slab(x, rows, n_tiles)
    b, hp, wp, c = x.shape
    dev = x.get_device()
    check("x", x, (b, hp, wp, c), torch.bfloat16, dev)
    chunk = flat_chunk_bytes(rows, wp, c)
    y = torch.empty_like(x)
    geom = (ctypes.c_int * 4)(hp, wp, rows, n_tiles)
    rc = _lib().pr_slab_flat(x.data_ptr(), y.data_ptr(), mechanism, b, c, geom, chunk,
                             stream(dev))
    launched(wrapper, rc, _error_string)
    return y.reshape(_out_shape("D", b, hp, wp, c))


def slab_copy_flat_loads(x, rows: int, n_tiles: int):
    """Layout D through plain 16-byte vector loads into shared memory."""
    return _slab_flat(slab_copy_flat_loads, 0, x, rows, n_tiles)


def slab_copy_flat_cp_async(x, rows: int, n_tiles: int):
    """Layout D through 16-byte ``cp.async`` into shared memory, two stages."""
    return _slab_flat(slab_copy_flat_cp_async, 1, x, rows, n_tiles)


KERNELS = (add_one, add_one_grid7, *TRIVIAL_DECODER.KERNELS, slab_copy_4d, slab_copy_3d,
           slab_copy_lane128, slab_copy_flat, slab_copy_flat_loads, slab_copy_flat_cp_async)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()
