"""The backbone block and the decode step's log-softmax + top-k as their
kernels were before their redesign for the H100 (``csrc/previous.cu``), so
that one run can time the previous and the present design in turns on the
same card (``chip_smoke.py``). Nothing on any path of the port calls them.

``fused_ir_block_previous`` takes bfloat16 only (the serving dtype) and
``decoder_logsoftmax_topk_previous`` stages a row's totals in shared memory,
so V·4 bytes must fit it. Both run on CUDA tensors only and count their
launches in ``.launches``; their results are those of
``fused_backbone.fused_ir_block_reference`` and
``fused_decoder.decoder_logsoftmax_topk_reference``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._build import MAX_SMEM, check, launched, load_library, stream

__all__ = ["fused_ir_block_previous", "decoder_logsoftmax_topk_previous", "tile_plan"]

_NJ_CHOICES = (1, 2, 3, 5, 10)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("previous")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.pv_ir_block.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, I, P]
    lib.pv_logsoftmax_topk.argtypes = [P, P, P, P, P, I, I, I, P]
    lib.pv_ir_block.restype = lib.pv_logsoftmax_topk.restype = I
    lib.pv_error_string.argtypes, lib.pv_error_string.restype = [I], ctypes.c_char_p
    return lib


def _error_string(rc: int) -> bytes:
    return _lib().pv_error_string(rc)


def tile_plan(cin: int, cout: int, stride: int) -> tuple[int, int]:
    """(th, NJ) of the previous block kernel: NJ·32 output channels a block,
    the largest th in 8, 4, 2, 1 whose float32 staging fits."""
    nj = next((n for n in _NJ_CHOICES if 32 * n >= cout), _NJ_CHOICES[-1])
    cin4 = -(-cin // 4) * 4
    for th in (8, 4, 2, 1):
        p = ((th - 1) * stride + 3) * (7 * stride + 3)
        if 4 * (p * cin4 + cin4 * 32 + p * 32 + th * 256 + 1024 * nj) <= MAX_SMEM:
            return th, nj
    raise ValueError(f"fused_ir_block_previous: {cin} input channels do not fit")


def fused_ir_block_previous(x: torch.Tensor, blk: dict, *, stride: int,
                            residual: bool) -> torch.Tensor:
    b, h, w, cin = x.shape
    cexp, cout = blk["w_proj"].shape
    dev = x.get_device()
    check("x", x, (b, h, w, cin), torch.bfloat16, dev)
    th, nj = tile_plan(cin, cout, stride)
    y = x.new_empty((b, h // stride, w // stride, cout))
    ptr = lambda k: blk[k].data_ptr() if k in blk else None
    rc = _lib().pv_ir_block(
        x.data_ptr(), ptr("w_exp"), ptr("b_exp"), ptr("w_dw"), ptr("b_dw"), ptr("w_proj"),
        ptr("b_proj"), y.data_ptr(), b, h, w, cin, cexp, cout, stride, int(residual), th, nj,
        1, stream(dev))
    launched(fused_ir_block_previous, rc, _error_string)
    return y


def decoder_logsoftmax_topk_previous(logits, scores, finished, topk: int):
    bk, v = logits.shape
    if not 0 < topk <= v or v * 4 > MAX_SMEM:
        raise ValueError(f"decoder_logsoftmax_topk_previous: topk={topk}, V={v} unsupported")
    dev = logits.get_device()
    check("logits", logits, (bk, v), torch.float32, dev)
    out_s = logits.new_empty((bk, topk))
    out_i = logits.new_empty((bk, topk), dtype=torch.int32)
    rc = _lib().pv_logsoftmax_topk(
        logits.data_ptr(), scores.reshape(-1).data_ptr(), finished.reshape(-1).data_ptr(),
        out_s.data_ptr(), out_i.data_ptr(), bk, v, topk, stream(dev))
    launched(decoder_logsoftmax_topk_previous, rc, _error_string)
    return out_s, out_i


fused_ir_block_previous.launches = decoder_logsoftmax_topk_previous.launches = 0
