"""The yardstick's arithmetic: the H100's peaks, the model FLOPs of a caption
call and of a training step, and the operations and bytes of one decode
step of the beam search, all from shapes.

The decode step is counted whole, not kernel by kernel, so that a change
that fuses or splits its kernels reads against the same count: its
operations are every product the step needs; its bytes are each input read
once and each output written once (the weights, the self-attention K/V rows
that the beams' ancestry reaches, the cross-attention K/V, the step's input
rows and its cache writes and candidates), and no intermediate activation."""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def decode_step(d: int, dff: int, layers: int, vocab: int, items: int, beam: int,
                lenc: int, pos: int, distinct_rows: float, esz: int = 2) -> tuple[float, float]:
    """``(flops, bytes)`` of the step that writes position ``pos`` (0-based)
    for ``items × beam`` rows; ``distinct_rows`` is the mean number of
    (position, beam) self-attention cache rows an item's beams read over
    positions ``0..pos`` (``reference.decode.distinct_ancestors``)."""
    rows = items * beam
    per_layer_w = d * 3 * d + 3 * d * d + 2 * d * dff          # qkv, out, cross q, cross out, ffn
    per_layer_b = 3 * d + 3 * d + dff + d                       # their biases
    mm = 2 * rows * (per_layer_w * layers + d * vocab)
    attn = layers * 4 * rows * d * ((pos + 1) + lenc)           # QK and PV, self and cross
    flops = mm + attn
    weights = (layers * (per_layer_w + per_layer_b) + d * vocab + vocab) * esz
    norms = layers * 3 * 2 * d * 4                               # LayerNorm scale, offset f32
    # the rows of position pos are the step's own output, counted below
    self_kv = layers * items * max(distinct_rows - beam, 0.0) * 2 * d * esz
    cross_kv = layers * items * lenc * 2 * d * esz
    io = (rows * d * esz                                         # the embedded tokens in
          + layers * rows * 2 * d * esz                          # the new K/V rows out
          + (pos + 1) * rows * 4                                 # the ancestry in
          + rows * 2 * 4                                         # scores, finished in
          + rows * beam * 2 * 4)                                 # candidates out
    return float(flops), float(weights + norms + self_kv + cross_kv + io)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of operations over
    the bf16 peak and bytes over the memory rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def decode_least_seconds(cfg: dict, vocab: int, items: int, lenc: int,
                         distinct: list[float]) -> list[float]:
    """The least time of each of the ``len(distinct)`` steps of a call."""
    return [least_seconds(*decode_step(cfg["d_model"], cfg["dff"], cfg["num_layers"], vocab, items,
                                       cfg["beam_search_n"], lenc, t, r))
            for t, r in enumerate(distinct)]


def decode_flops(cfg: dict, vocab: int, items: int, lenc: int, steps: int) -> float:
    """The products of ``steps`` decode steps and of the cross-attention K/V
    projected once for the call."""
    d, layers = cfg["d_model"], cfg["num_layers"]
    cross_kv = layers * 2 * items * lenc * d * 2 * d
    return cross_kv + sum(decode_step(d, cfg["dff"], layers, vocab, items,
                                      cfg["beam_search_n"], lenc, t, 0.0)[0]
                            for t in range(steps))


def model_flops(fn) -> float:
    """The products ``fn()`` runs, counted by ``FlopCounterMode`` (call it
    on meta tensors: nothing is computed)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def encode_flops(model, batch: int, size: int) -> float:
    """The encode of ``batch`` images of ``model`` (the reference, on meta)."""
    img = torch.zeros((batch, size, size, 3), dtype=torch.uint8, device="meta")
    model.requires_grad_(False)
    try:
        return model_flops(lambda: model.encode(img))
    finally:
        model.requires_grad_(True)


def train_flops(model, batch: int, size: int, length: int) -> float:
    """Forward and backward of a training step of ``batch`` images and
    captions of ``length`` tokens (the reference, on meta)."""
    img = torch.zeros((batch, size, size, 3), dtype=torch.uint8, device="meta")
    caps = torch.ones((batch, length), dtype=torch.long, device="meta")
    params = [p for p in model.parameters()]

    def step():
        logits = model.forward_train(img, caps[:, :-1])
        torch.autograd.grad(logits.float().sum(), params, allow_unused=True)

    return model_flops(step)
