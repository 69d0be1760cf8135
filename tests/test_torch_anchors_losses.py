"""The port's anchors (``models/anchors.py``) and detection losses
(``train/losses.py``) against the JAX package's on the CPU: the anchors
bitwise (both are numpy), ``shift_boxes``/``box_decode`` within 1e-6, and
each loss with its gradient (torch autograd against ``jax.grad``) within
1e-6 relative in float32, on seeded inputs whose logits reach ±30, where a
naive sigmoid loses its precision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_torch.models import anchors as pt_anchors
from fpn_mt_image_captioning_torch.train import losses as pt_losses
from fpn_mt_image_captioning_tpu.models import anchors as jx_anchors
from fpn_mt_image_captioning_tpu.train import losses as jx_losses

RTOL = 1e-6


@pytest.mark.parametrize("level", [3, 4, 5, 6, 7])
@pytest.mark.parametrize("hw", [(4, 4), (3, 5)])
def test_anchors_for_level_bitwise(level, hw):
    got = pt_anchors.anchors_for_level(*hw, level)
    want = jx_anchors.anchors_for_level(*hw, level)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("size", [200, 256, 333, 512])
def test_all_anchors_bitwise(size):
    params = pt_anchors.AnchorParameters(sizes=(16, 32, 64, 128, 256))
    for got, want in ((pt_anchors.all_anchors(size), jx_anchors.all_anchors(size)),
                      (pt_anchors.all_anchors(size, params),
                       jx_anchors.all_anchors(size, jx_anchors.AnchorParameters(
                           sizes=(16, 32, 64, 128, 256))))):
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_anchor_counts_geometry_and_pyramid_total():
    """What ``tests/test_aux_components.py`` asserts of the JAX anchors."""
    params = pt_anchors.AnchorParameters()
    assert params.num_anchors == 9
    a = pt_anchors.anchors_for_level(4, 4, 3, params)
    assert a.shape == (4 * 4 * 9, 4)
    first = a[3]   # ratio 1.0, scale 1: a 32×32 box centred on (4, 4)
    np.testing.assert_allclose([first[2] - first[0], first[3] - first[1]], [32, 32],
                               rtol=1e-5)
    np.testing.assert_allclose([(first[0] + first[2]) / 2, (first[1] + first[3]) / 2],
                               [4.0, 4.0], atol=1e-5)
    total = sum((256 // s) ** 2 * 9 for s in (8, 16, 32, 64, 128))
    assert pt_anchors.all_anchors(256).shape == (total, 4)


def _boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    wh = rng.uniform(1, 120, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], axis=1)


@pytest.mark.parametrize("stats", [None, ((0.1, -0.2, 0.0, 0.3), (0.1, 0.2, 0.3, 0.4))])
def test_shift_boxes_matches_jax(stats):
    rng = np.random.default_rng(0)
    boxes, deltas = _boxes(rng, 50), rng.standard_normal((3, 50, 4)).astype(np.float32) * 3
    kw = {} if stats is None else dict(mean=stats[0], std=stats[1])
    got = pt_anchors.shift_boxes(torch.from_numpy(boxes), torch.from_numpy(deltas), **kw)
    want = np.asarray(jx_anchors.shift_boxes(jnp.asarray(boxes), jnp.asarray(deltas), **kw))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("size", [64, 256])
def test_box_decode_matches_jax_and_clips(size):
    rng = np.random.default_rng(1)
    anchors = pt_anchors.all_anchors(size)
    deltas = (rng.standard_normal((2, len(anchors), 4)) * 10).astype(np.float32)
    got = pt_anchors.box_decode(anchors, torch.from_numpy(deltas), size)
    want = np.asarray(jx_anchors.box_decode(anchors, jnp.asarray(deltas), size))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6 * size)
    assert float(got.max()) <= size and float(got.min()) >= 0.0
    one = pt_anchors.box_decode(np.array([[0, 0, 32, 32]], np.float32),
                                torch.full((1, 4), 10.0), image_size=64)
    assert float(one.max()) <= 64.0 and float(one.min()) >= 0.0


def _logits(rng, shape):
    """Standard normal logits with a tenth of them pushed to ±(20..30)."""
    x = rng.standard_normal(shape).astype(np.float32) * 3
    big = rng.random(shape) < 0.1
    x[big] = np.sign(x[big]) * rng.uniform(20, 30, big.sum()).astype(np.float32)
    return x


def _labels(rng, shape, ignore: bool):
    lab = (rng.random(shape) < 0.2).astype(np.float32)
    if ignore:
        lab[rng.random(shape[:-1]) < 0.2] = -1.0
    return lab


def _cases():
    rng = np.random.default_rng(7)
    shape = (2, 40, 5)
    return {
        "focal": (lambda m, a, b: m.focal_loss(a, b), _labels(rng, shape, False),
                  _logits(rng, shape)),
        "focal_ignore_rows": (lambda m, a, b: m.focal_loss(a, b, alpha=0.4, gamma=1.5),
                              _labels(rng, shape, True), _logits(rng, shape)),
        "sigmoid_ce": (lambda m, a, b: m.optax_sigmoid_ce(a, b).sum(),
                       _labels(rng, shape, False), _logits(rng, shape)),
        "weighted_mse_light": (lambda m, a, b: m.weighted_mse_loss(a, b, True),
                               rng.random((2, 6, 6, 3)).astype(np.float32),
                               rng.random((2, 6, 6, 3)).astype(np.float32)),
        "weighted_mse_dark": (lambda m, a, b: m.weighted_mse_loss(a, b, False),
                              rng.random((2, 6, 6, 3)).astype(np.float32),
                              rng.random((2, 6, 6, 3)).astype(np.float32)),
        "smooth_l1": (lambda m, a, b: m.smooth_l1_loss(a, b),
                      rng.standard_normal((3, 30, 4)).astype(np.float32),
                      (rng.standard_normal((3, 30, 4)) * 0.3).astype(np.float32)),
        "smooth_l1_sigma1": (lambda m, a, b: m.smooth_l1_loss(a, b, sigma=1.0),
                             rng.standard_normal((3, 30, 4)).astype(np.float32),
                             (rng.standard_normal((3, 30, 4)) * 2).astype(np.float32)),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_gradient_match_jax(name):
    """The value and its gradient in the second argument (the logits or the
    prediction)."""
    fn, a, b = CASES[name]
    want, want_grad = jax.value_and_grad(lambda x: fn(jx_losses, jnp.asarray(a), x))(
        jnp.asarray(b))
    x = torch.tensor(b, requires_grad=True)
    got = fn(pt_losses, torch.from_numpy(a), x)
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    want_grad = np.asarray(want_grad)
    assert np.all(np.isfinite(x.grad.numpy()))
    np.testing.assert_allclose(x.grad.numpy(), want_grad, rtol=RTOL,
                               atol=RTOL * np.abs(want_grad).max())


def test_sigmoid_ce_is_stable_at_large_logits():
    """At ±30 the naive ``-z log σ(x) - (1-z) log(1-σ(x))`` is inf or 0 in
    float32; the stable form is exact: ``log1p(exp(-30))`` ≈ 9.4e-14."""
    x = torch.tensor([30.0, -30.0, 30.0, -30.0])
    z = torch.tensor([1.0, 0.0, 0.0, 1.0])
    got = pt_losses.optax_sigmoid_ce(z, x)
    np.testing.assert_allclose(got.numpy(), [np.log1p(np.exp(-30.0)), np.log1p(np.exp(-30.0)),
                                             30.0, 30.0], rtol=1e-6)


def test_weighted_mse_inventory_case():
    """``tests/test_inventory_extras.py``'s case (tied brightness values: the
    gradient of min/max shared among ties, as in JAX) against JAX."""
    pred = np.array([[[1.0, 1.0, 1.0], [0.0, 0.0, 0.0]], [[0.5, 0.5, 0.5], [1.0, 1.0, 1.0]]],
                    np.float32)
    target = np.zeros((2, 2, 3), np.float32)
    want, want_grad = jax.value_and_grad(
        lambda p: jx_losses.weighted_mse_loss(jnp.asarray(target), p, light_background=True))(
        jnp.asarray(pred))
    x = torch.tensor(pred, requires_grad=True)
    got = pt_losses.weighted_mse_loss(torch.from_numpy(target), x, light_background=True)
    got.backward()
    assert np.isfinite(float(got)) and float(got) > 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=1e-7)
    dark = pt_losses.weighted_mse_loss(torch.tensor([[[0.2], [1.0]]]),
                                       torch.tensor([[[0.0], [1.0]]]))
    assert np.isfinite(float(dark))
