"""The yardstick's arithmetic against closed forms at small shapes."""

from __future__ import annotations

import math

import pytest
import torch

from gpubench import counts, inputs
from gpubench.reference import decode as ref_decode


def step_products(rows, d, dff, layers, vocab, pos, lenc, heads):
    """Run the products of one decode step on small tensors (what the step
    computes, by shape) and count them with ``FlopCounterMode``."""
    x = torch.randn(rows, d)
    w = lambda k, n: torch.randn(k, n)
    dh = d // heads
    for _ in range(layers):
        qkv = x @ w(d, 3 * d)
        q, k = qkv[:, :d].reshape(rows, heads, dh), torch.randn(rows, pos + 1, heads, dh)
        att = torch.einsum("rhd,rlhd->rhl", q, k)
        ctx = torch.einsum("rhl,rlhd->rhd", att, k).reshape(rows, d)
        h = ctx @ w(d, d)
        cq = (h @ w(d, d)).reshape(rows, heads, dh)
        ck = torch.randn(rows, lenc, heads, dh)
        cctx = torch.einsum("rhl,rlhd->rhd", torch.einsum("rhd,rlhd->rhl", cq, ck), ck)
        h = cctx.reshape(rows, d) @ w(d, d)
        x = (h @ w(d, dff)) @ w(dff, d)
    x @ w(d, vocab)


@pytest.mark.parametrize("pos", [1, 3, 7])
def test_decode_step_operations(pos):
    # from position 1 on: over one key the einsum is no product to the counter
    shape = dict(d=16, dff=32, layers=2, vocab=40, lenc=4, heads=2)
    items, beam = 3, 2
    got, _ = counts.decode_step(shape["d"], shape["dff"], shape["layers"], shape["vocab"], items,
                                beam, shape["lenc"], pos, beam)
    want = counts.model_flops(lambda: step_products(items * beam, pos=pos, **shape))
    assert got == want


def test_decode_step_bytes():
    """bf16 weights and biases once, LayerNorm f32, the self-attention rows
    the ancestry reads beyond the step's own, cross K/V, the step's rows."""
    d, dff, layers, vocab, items, beam, lenc, pos, distinct = 8, 16, 1, 10, 2, 2, 3, 2, 5.0
    _, got = counts.decode_step(d, dff, layers, vocab, items, beam, lenc, pos, distinct)
    rows = items * beam
    weights = (3 * d * d + 3 * d * d + 2 * d * dff + 6 * d + dff + d + d * vocab + vocab) * 2
    norms = 3 * 2 * d * 4
    self_kv = items * (distinct - beam) * 2 * d * 2
    cross = items * lenc * 2 * d * 2
    io = rows * d * 2 + rows * 2 * d * 2 + (pos + 1) * rows * 4 + rows * 2 * 4 + rows * beam * 8
    assert got == weights + norms + self_kv + cross + io


def test_least_seconds_is_the_larger_bound():
    assert counts.least_seconds(989e12, 0.0) == pytest.approx(1.0)
    assert counts.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_seconds(1e12, 3.35e12) == pytest.approx(1.0)


def test_decode_flops_sums_the_steps():
    cfg = dict(d_model=16, dff=32, num_layers=2, beam_search_n=2)
    steps = [counts.decode_step(16, 32, 2, 40, 3, 2, 4, t, 0.0)[0] for t in range(5)]
    cross_kv = 2 * 2 * 3 * 4 * 16 * 32
    assert counts.decode_flops(cfg, 40, 3, 4, 5) == cross_kv + sum(steps)


def test_encode_and_train_flops_of_a_conv():
    """FlopCounterMode's count of the reference's convolution and dense
    layer: 2·out·in·k²·H·W and 2·rows·in·out, the backward twice more."""
    from gpubench.reference.model import Conv, Dense

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv, self.dense = Conv(3, 5, 3), Dense(5 * 8 * 8, 7)

        def encode(self, img):
            x = self.conv(img.float().permute(0, 3, 1, 2))
            return self.dense(x.flatten(1))

        def forward_train(self, img, caps):
            return self.encode(img)

    with torch.device("meta"):
        net = Net()
    fwd = 2 * (5 * 3 * 9 * 8 * 8) * 2 + 2 * 2 * (5 * 64) * 7
    assert counts.encode_flops(net, 2, 8) == fwd
    # backward: the input and weight gradients of the dense layer and the
    # weight gradient of the conv (its input needs none)
    assert counts.train_flops(net, 2, 8, 4) == fwd + 2 * 2 * 2 * 320 * 7 + 2 * 5 * 27 * 64 * 2


def test_distinct_ancestors():
    """Two beams, three steps: step 0 both from beam 0; step 1 both from
    beam 1; step 2 beam 0 from 0 and beam 1 from 1."""
    parents = torch.tensor([[[0, 0]], [[1, 1]], [[0, 1]]])
    got = ref_decode.distinct_ancestors(parents)
    # t0: own 2; t1: own 2 + position 0: {0} -> 3; t2: own 2 + pos 1: {1} + pos 0: {0} -> 4
    assert got == [2.0, 3.0, 4.0]


def test_weights_are_seeded_and_fit_the_reference():
    from conftest import TINY

    TINY_CFG = dict(TINY)
    a = inputs.make_weights(TINY_CFG, 60, 5, "cpu")
    b = inputs.make_weights(TINY_CFG, 60, 5, "cpu")
    c = inputs.make_weights(TINY_CFG, 60, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    model = inputs.reference_model(TINY_CFG, 60, "cpu")
    model.load_state_dict(a)
    with torch.no_grad():
        enc = model.encode(torch.zeros(1, 256, 256, 3, dtype=torch.uint8))
    assert math.isfinite(float(enc.sum()))
