"""The port's layer functions against the JAX package's, on the same seeded
numpy inputs (float32, atol 1e-6). The port's vision stack is NCHW, the JAX
package's NHWC, so spatial inputs are permuted on the way in and out."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_tpu.models import coattention as jx_coatt
from fpn_mt_image_captioning_tpu.models import layers as jx_layers
from fpn_mt_image_captioning_tpu.models import positional as jx_pos
from fpn_mt_image_captioning_torch.models import coattention as pt_coatt
from fpn_mt_image_captioning_torch.models import layers as pt_layers
from fpn_mt_image_captioning_torch.models import positional as pt_pos

ATOL = 1e-6


def nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def test_normalize_every_byte_value():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, axis=3)
    want = np.asarray(jx_layers.normalize_images(jnp.asarray(u8)))
    got = pt_layers.normalize_images(torch.from_numpy(u8))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # float inputs pass through untouched
    f = np.linspace(-1, 1, 12, dtype=np.float32)
    assert torch.equal(pt_layers.normalize_images(torch.from_numpy(f)), torch.from_numpy(f))


@pytest.mark.parametrize("name", ["leaky_relu", "relu", "relu6", "gelu"])
def test_activation(name):
    x = (np.random.default_rng(1).standard_normal((64, 33)) * 4).astype(np.float32)
    want = np.asarray(jx_layers.resolve_activation(name)(jnp.asarray(x)))
    got = pt_layers.resolve_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("position,d_model", [(60, 512), (256, 32), (7, 6)])
def test_positional_encoding(position, d_model):
    np.testing.assert_array_equal(
        pt_pos.raw_positional_encoding(position, d_model),
        jx_pos.raw_positional_encoding(position, d_model))


@pytest.mark.parametrize("hw,c", [((8, 8), 16), ((2, 3), 5)])
def test_coattention(hw, c):
    rng = np.random.default_rng(2)
    score = (rng.standard_normal((2, *hw, 1)) * 3).astype(np.float32)
    hs = rng.standard_normal((2, *hw, c)).astype(np.float32)
    want = np.asarray(jx_coatt.coattention(jnp.asarray(score), jnp.asarray(hs)))
    got = nhwc(pt_coatt.coattention(nchw(score), nchw(hs)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("src_hw,dst_hw", [((4, 4), (8, 8)), ((2, 3), (8, 6)), ((3, 5), (4, 7))])
def test_upsample_like(src_hw, dst_hw):
    x = np.random.default_rng(3).standard_normal((2, *src_hw, 4)).astype(np.float32)
    want = np.asarray(jx_layers.upsample_like(jnp.asarray(x), dst_hw))
    got = nhwc(pt_layers.upsample_like(nchw(x), dst_hw))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw", [(8, 8), (5, 7)])
def test_max_pool_2x(hw):
    x = np.random.default_rng(4).standard_normal((2, *hw, 3)).astype(np.float32)
    want = np.asarray(jx_layers.max_pool_2x(jnp.asarray(x)))
    got = nhwc(pt_layers.max_pool_2x(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n,k,s", [(16, 3, 2), (15, 3, 2), (8, 3, 1), (8, 1, 1), (9, 1, 2)])
def test_same_conv_matches_xla_padding(n, k, s):
    """TF/XLA "SAME": a stride-2 3×3 on an even extent pads 0 before, 1 after."""
    import jax

    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, n, n, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    conv = pt_layers.SameConv2d(3, 4, k, s, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = nhwc(conv(nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
