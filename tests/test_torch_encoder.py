"""The port's encoder (MobileNetV2 → FPN → views → UMV encoder) and teacher-
forced decoder against the Flax modules, with the same perturbed weights
carried across by ``weights.from_flax`` (float32, atol 1e-4), and the port's
MobileNetV2 against real Keras activations (the JAX package's golden file)."""

import os
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_tpu.models.positional import create_masks
from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
from fpn_mt_image_captioning_torch.models.backbones.mobilenet_v2 import MobileNetV2Backbone
from fpn_mt_image_captioning_torch.models.transformer import Transformer as PtTransformer
from fpn_mt_image_captioning_torch.weights import from_flax

ATOL = 1e-4
KW = dict(num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=256,
          target_vocab_size=40, max_seq_len=8, backbone_name="mobilenet224_0.35")
SIZE = 256


def perturb(tree, rng):
    """Seeded noise on every leaf — biases, LayerNorm/BN scales and BN
    statistics init to 0 or 1, which would hide a mapping bug. Variances
    are scaled, staying positive."""
    if isinstance(tree, Mapping):
        return {k: perturb(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    noise = rng.standard_normal(a.shape).astype(np.float32)
    return a + 0.1 * (a.std() or 1.0) * noise


def perturb_variables(variables, seed):
    rng = np.random.default_rng(seed)
    out = {"params": perturb(jax.device_get(variables["params"]), rng)}
    stats = jax.device_get(variables["batch_stats"])
    out["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a, np.float32) * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if p[-1].key == "var" else np.asarray(a, np.float32)
        + 0.1 * rng.standard_normal(a.shape).astype(np.float32), stats)
    return out


@pytest.fixture(scope="module")
def models():
    jx = JxTransformer(**KW)
    key = jax.random.PRNGKey(3)
    tar = jnp.ones((1, 4), jnp.int32)
    img = jnp.zeros((1, SIZE, SIZE, 3))
    variables = perturb_variables(
        jax.jit(lambda i, t: jx.init({"params": key, "dropout": key}, i, t, True,
                                     create_masks(t)))(img, tar), seed=11)
    pt = PtTransformer(**KW).eval()
    pt.load_state_dict(from_flax(variables), strict=True)
    images = np.random.default_rng(12).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    return jx, variables, pt, images


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def test_from_flax_maps_every_leaf(models):
    _jx, variables, pt, _ = models
    state = from_flax(variables)
    assert set(state) == set(pt.state_dict())
    # a Dense kernel is transposed, a depthwise HWIO kernel becomes (C, 1, 3, 3)
    dense = variables["params"]["decoder"]["layer_0"]["mha1"]["wq"]["kernel"]
    np.testing.assert_array_equal(state["decoder.layer_0.mha1.wq.weight"].numpy(), dense.T)
    dw = state["encoder.feature_extractor.backbone.block_1_0.depthwise.conv.weight"]
    assert dw.shape[1:] == (1, 3, 3)


def test_backbone_taps(models):
    jx, variables, pt, images = models
    x = images.astype(np.float32) / 127.5 - 1.0
    want = jax.jit(lambda v, x: jx.apply(
        v, x, method=lambda m, x: m.encoder.feature_extractor.backbone(x, train=False)))(
        variables, x)
    with torch.no_grad():
        got = pt.encoder.feature_extractor.backbone(torch.from_numpy(x).permute(0, 3, 1, 2))
    for name, w, g in zip(("C3", "C4", "C5"), want, got):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=ATOL, err_msg=name)


def test_feature_extractor_views(models):
    jx, variables, pt, images = models
    x = images.astype(np.float32) / 127.5 - 1.0
    want = jax.jit(lambda v, x: jx.apply(
        v, x, method=lambda m, x: m.encoder.feature_extractor(x, train=False)))(variables, x)
    with torch.no_grad():
        got = pt.encoder.feature_extractor(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert [tuple(g.shape[2:]) for g in got] == [(16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(nhwc(g), np.asarray(w), rtol=0, atol=ATOL, err_msg=f"view {i}")


def test_encode(models):
    jx, variables, pt, images = models
    want = jax.jit(lambda v, x: jx.apply(v, x, train=False, method=JxTransformer.encode))(
        variables, images)
    with torch.no_grad():
        got = pt.encode(torch.from_numpy(images))
    assert got.shape == (2, 4, KW["d_model"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_teacher_forced_decoder(models):
    jx, variables, pt, _ = models
    rng = np.random.default_rng(13)
    enc = rng.standard_normal((2, 4, KW["d_model"])).astype(np.float32)
    tar = rng.integers(1, KW["target_vocab_size"], (2, 6)).astype(np.int32)
    tar[1, 4:] = 0
    mask = np.array(create_masks(jnp.asarray(tar)))
    want_logits, want_att = jx.apply(variables, enc, tar, False, mask)
    with torch.no_grad():
        got_logits, got_att = pt(torch.from_numpy(enc), torch.from_numpy(tar).long(),
                                 torch.from_numpy(mask))
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=0, atol=ATOL)
    assert set(got_att) == set(want_att)
    np.testing.assert_allclose(got_att["decoder_layer2_block1"].numpy(),
                               np.asarray(want_att["decoder_layer2_block1"]), atol=ATOL)


def test_project_kv(models):
    """The cross-attention K/V projection, (B, L, H, D) each, as JAX's."""
    jx, variables, pt, _ = models
    enc = np.random.default_rng(14).standard_normal((2, 4, KW["d_model"])).astype(np.float32)
    want = jx.apply(variables, enc, method=lambda m, e: m.decoder.dec_layers[1].mha2.project_kv(e))
    with torch.no_grad():
        got = pt.decoder.layer_1.mha2.project_kv(torch.from_numpy(enc))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_mobilenet_matches_keras_golden():
    """Keras MobileNetV2 (alpha 0.35) weights imported through the JAX
    package's h5 mapper, carried across by from_flax, must reproduce Keras'
    C3/C4/C5 activations — the JAX package's own bar (atol 2e-4, rtol 1e-3)."""
    pytest.importorskip("h5py")
    from fpn_mt_image_captioning_tpu.models.backbones.mobilenet_v2 import (
        MobileNetV2Backbone as JxBackbone,
    )
    from fpn_mt_image_captioning_tpu.utils.weight_import import import_retinanet_weights

    golden_dir = os.path.join(os.path.dirname(__file__), "golden")
    golden = np.load(os.path.join(golden_dir, "mobilenet_v2_a035_golden.npz"))
    alpha = float(golden["alpha"])
    shapes = jax.eval_shape(
        lambda x: JxBackbone(alpha=alpha).init({"params": jax.random.PRNGKey(0)}, x, train=False),
        jnp.asarray(golden["x"]))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    nested = {
        "params": {"encoder": {"feature_extractor": {"backbone": zeros["params"], "fpn": {}}}},
        "batch_stats": {"encoder": {"feature_extractor": {"backbone": zeros["batch_stats"]}}},
    }
    new_vars, report = import_retinanet_weights(
        nested, os.path.join(golden_dir, "mobilenet_v2_a035.h5"))
    assert len(report.matched) >= 150
    fe = new_vars["params"]["encoder"]["feature_extractor"]
    fe_s = new_vars["batch_stats"]["encoder"]["feature_extractor"]

    net = MobileNetV2Backbone(alpha=alpha).eval()
    net.load_state_dict(from_flax({"params": fe["backbone"], "batch_stats": fe_s["backbone"]}),
                        strict=True)
    with torch.no_grad():
        taps = net(torch.from_numpy(golden["x"]).permute(0, 3, 1, 2))
    for name, t in zip(("C3", "C4", "C5"), taps):
        np.testing.assert_allclose(nhwc(t), golden[name], atol=2e-4, rtol=1e-3, err_msg=name)
