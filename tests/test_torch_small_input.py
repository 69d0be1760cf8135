"""Inputs below 256²: at 64² the smallest pyramid views are empty, and the JAX
package passes the empty arrays through (Flax's convs and max pool accept
them), so its encode gives an empty (B, 0, d_model). The port must give the
same shapes on the eager route and through ``encode_from_taps`` (the fused
backbone's route), with the non-empty views' values (float32, atol 1e-4, the
bar of ``test_torch_encoder.py``, whose perturbed weights these are)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_encoder import ATOL, KW, nhwc, perturb_variables

from fpn_mt_image_captioning_tpu.models.layers import max_pool_2x as jx_max_pool_2x
from fpn_mt_image_captioning_tpu.models.positional import create_masks
from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
from fpn_mt_image_captioning_torch.models.layers import SameConv2d, max_pool_2x
from fpn_mt_image_captioning_torch.models.transformer import Transformer as PtTransformer
from fpn_mt_image_captioning_torch.ops import fused_backbone as fb
from fpn_mt_image_captioning_torch.weights import from_flax

SIZE = 64
VIEW_HW = [(4, 4), (2, 2), (1, 1), (0, 0), (0, 0)]   # P3'..P7' at 64²


@pytest.fixture(scope="module")
def models():
    jx = JxTransformer(**KW)
    key = jax.random.PRNGKey(5)
    tar = jnp.ones((1, 4), jnp.int32)
    variables = perturb_variables(
        jax.jit(lambda i, t: jx.init({"params": key, "dropout": key}, i, t, True,
                                     create_masks(t)))(jnp.zeros((1, SIZE, SIZE, 3)), tar),
        seed=21)
    pt = PtTransformer(**KW).eval()
    pt.load_state_dict(from_flax(variables), strict=True)
    images = np.random.default_rng(22).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    x = images.astype(np.float32) / 127.5 - 1.0
    taps = jax.jit(lambda v, x: jx.apply(
        v, x, method=lambda m, x: m.encoder.feature_extractor.backbone(x, train=False)))(
        variables, x)
    return jx, variables, pt, images, x, [np.array(t) for t in taps]


def _views(route, jx, variables, pt, x, taps):
    if route == "eager":
        want = jax.jit(lambda v, x: jx.apply(
            v, x, method=lambda m, x: m.encoder.feature_extractor(x, train=False)))(variables, x)
        with torch.no_grad():
            got = pt.encoder.feature_extractor(torch.from_numpy(x).permute(0, 3, 1, 2))
    else:
        want = jax.jit(lambda v, *t: jx.apply(
            v, *t, method=lambda m, *t: m.encoder.feature_extractor.from_taps(*t)))(
            variables, *taps)
        with torch.no_grad():
            got = pt.encoder.feature_extractor.from_taps(*map(torch.from_numpy, taps))
    return want, got


@pytest.mark.parametrize("route", ["eager", "taps"])
def test_views_at_64(models, route):
    jx, variables, pt, _, x, taps = models
    want, got = _views(route, jx, variables, pt, x, taps)
    assert [tuple(w.shape[1:3]) for w in want] == VIEW_HW
    for i, (w, g) in enumerate(zip(want, got)):
        assert nhwc(g).shape == w.shape, f"view {i}"
        if w.size:
            np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=ATOL,
                                       err_msg=f"view {i}")


@pytest.mark.parametrize("route", ["eager", "taps", "fused"])
def test_encode_at_64_is_empty_as_in_jax(models, route):
    jx, variables, pt, images, _, taps = models
    want = jax.jit(lambda v, x: jx.apply(v, x, train=False, method=JxTransformer.encode))(
        variables, images)
    with torch.no_grad():
        if route == "eager":
            got = pt.encode(torch.from_numpy(images))
        elif route == "taps":
            got = pt.encode_from_taps(*map(torch.from_numpy, taps))
        else:
            packed = fb.pack_backbone_weights(pt.encoder.feature_extractor.backbone, torch.float32)
            got = fb.fused_encode(pt, packed, torch.from_numpy(images))
    assert tuple(got.shape) == want.shape == (2, 0, KW["d_model"])
    assert got.dtype == torch.float32


@pytest.mark.parametrize("hw", [(1, 1), (0, 0), (1, 3), (3, 3), (0, 4)])
def test_max_pool_2x_small_extents(hw):
    x = np.random.default_rng(sum(hw)).standard_normal((2, *hw, 5)).astype(np.float32)
    want = np.asarray(jx_max_pool_2x(jnp.asarray(x)))
    got = nhwc(max_pool_2x(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert got.shape == want.shape == (2, hw[0] // 2, hw[1] // 2, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("hw", [(1, 1), (0, 0), (0, 3)])
def test_same_conv_small_extents(hw, stride):
    """3×3 SAME conv against Flax's ``nn.Conv`` with the same weights."""
    rng = np.random.default_rng(hw[1] + stride)
    x = rng.standard_normal((2, *hw, 4)).astype(np.float32)
    kernel = rng.standard_normal((3, 3, 4, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    conv = fnn.Conv(6, (3, 3), strides=(stride, stride), padding="SAME")
    want = np.asarray(conv.apply({"params": {"kernel": kernel, "bias": bias}}, jnp.asarray(x)))
    pt = SameConv2d(4, 6, 3, stride=stride)
    with torch.no_grad():
        pt.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        pt.bias.copy_(torch.from_numpy(bias))
        got = nhwc(pt(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
