"""The port's fused MobileNetV2 backbone (``ops/fused_backbone.py``) against
the JAX package's, on the CPU: folded weights value by value, one block's
plain version against the TPU kernel in the Pallas interpreter, the whole
backbone and the fused serving encode, the odd-extent guard, and the
pipeline's fused route against its eager one. Inputs are made by numpy from
a seed; BatchNorm statistics are perturbed so that the folding matters.

Tolerances (float32): one block and C3/C4 atol 2e-4 + rtol 1e-3 (the bar of
``tests/test_fused_backbone.py``); C5, after the 1280-wide head, and the
encode atol 2e-3 + rtol 1e-3 (summation order through more layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_tpu.models.backbones.mobilenet_v2 import (
    MobileNetV2Backbone as JxBackbone,
)
from fpn_mt_image_captioning_tpu.ops import fused_backbone as jfb
from fpn_mt_image_captioning_torch.models.backbones.mobilenet_v2 import MobileNetV2Backbone
from fpn_mt_image_captioning_torch.ops import fused_backbone as fb
from fpn_mt_image_captioning_torch.ops.fused_decoder import pack_decoder_weights
from fpn_mt_image_captioning_torch.weights import from_flax

SIZE = 64


def perturbed(variables, seed):
    """Float32 numpy variables with every BN statistic and parameter moved
    off its init (variances scaled, staying positive)."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32), jax.device_get(variables["params"]))
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: np.asarray(a, np.float32) * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if p[-1].key == "var" else np.asarray(a, np.float32)
        + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        jax.device_get(variables["batch_stats"]))
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module", params=[1.0, 0.35], ids=["alpha1.0", "alpha0.35"])
def backbones(request):
    alpha = request.param
    jx = JxBackbone(alpha=alpha, dtype=jnp.float32)
    v = perturbed(jx.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False), 1)
    pt = MobileNetV2Backbone(alpha=alpha).eval()
    pt.load_state_dict(from_flax(v), strict=True)
    return jx, v, pt


@pytest.fixture(scope="module")
def alpha1():
    jx = JxBackbone(alpha=1.0, dtype=jnp.float32)
    v = perturbed(jx.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)), train=False), 1)
    pt = MobileNetV2Backbone(alpha=1.0).eval()
    pt.load_state_dict(from_flax(v), strict=True)
    return (jx, v, pt, jfb.pack_backbone_weights(v["params"], v["batch_stats"], jnp.float32),
            fb.pack_backbone_weights(pt, torch.float32))


def test_pack_backbone_weights_matches_jax(backbones):
    """Every folded value equals the JAX package's (which pads channels to
    128 lanes and taps to 16 rows; the port keeps the real counts)."""
    _, v, pt = backbones
    want = jfb.pack_backbone_weights(v["params"], v["batch_stats"], jnp.float32)
    got = fb.pack_backbone_weights(pt, torch.float32)
    close = lambda g, w: np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    close(got["stem_k"].permute(2, 3, 1, 0), want["stem_k"])     # OIHW vs HWIO
    close(got["stem_b"], want["stem_b"])
    close(got["head_k"], want["head_k"])
    close(got["head_b"], want["head_b"])
    assert len(got["blocks"]) == len(want["blocks"]) == 17
    for (g, gm), (w, wm) in zip(got["blocks"], want["blocks"]):
        assert gm == wm
        cexp, cout = g["w_proj"].shape
        assert ("w_exp" in g) == ("w_exp" in w)
        if "w_exp" in g:
            cin = g["w_exp"].shape[0]
            close(g["w_exp"], w["w_exp"][:cin])
            close(g["b_exp"], w["b_exp"][0])
            # the padding the port drops is zero there
            assert not np.asarray(w["w_exp"][cin:]).any()
        close(g["w_dw"], w["w_dw"][:9, :cexp])
        close(g["b_dw"], w["b_dw"][0, :cexp])
        close(g["w_proj"], w["w_proj"][:cexp, :cout])
        close(g["b_proj"], w["b_proj"][0, :cout])


# (block, what it exercises): expansion 1; stride 1 with residual; stride 2;
# stride 1 with Cin != Cout
BLOCK_CASES = [(0, "expansion-1"), (2, "stride-1-residual"), (1, "stride-2"),
               (10, "stride-1-cin-ne-cout")]


@pytest.mark.parametrize("index,case", BLOCK_CASES, ids=[c for _, c in BLOCK_CASES])
def test_block_reference_matches_jax_kernel(alpha1, index, case):
    *_, jpacked, packed = alpha1
    jblk, meta = jpacked["blocks"][index]
    blk, pmeta = packed["blocks"][index]
    assert meta == pmeta
    cin = blk["w_exp"].shape[0] if "w_exp" in blk else blk["w_dw"].shape[1]
    h = w = 16
    x = np.random.default_rng(index).standard_normal((2, h, w, cin)).astype(np.float32)
    stride = meta["stride"]
    assert (case == "stride-2") == (stride == 2)
    assert (case == "stride-1-residual") == meta["residual"]

    xb = jfb.pad_to_bordered(jnp.asarray(x), c_pad=-(-cin // 128) * 128)
    y = jfb.fused_ir_block(xb, jblk, stride=stride, h_in=h, w_in=w,
                           residual=meta["residual"], interpret=True)
    if stride == 2:
        y = jfb._downselect_cols(y, w)
    want = np.asarray(jfb.unpad_bordered(y, h // stride, w // stride, c=meta["c_out"]))

    got = fb.fused_ir_block_reference(torch.from_numpy(x), blk, stride=stride,
                                      residual=meta["residual"])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    # the wrapper takes the plain version for a CPU tensor
    torch.testing.assert_close(
        fb.fused_ir_block(torch.from_numpy(x), blk, stride=stride, residual=meta["residual"]),
        got, rtol=0, atol=0)


def test_fused_backbone_matches_jax(alpha1):
    *_, jpacked, packed = alpha1
    images = (np.random.default_rng(5).standard_normal((2, SIZE, SIZE, 3)) * 0.5).astype(
        np.float32)
    want = jfb.fused_mobilenet_backbone(jpacked, jnp.asarray(images), interpret=True)
    got = fb.fused_mobilenet_backbone(packed, torch.from_numpy(images))
    for name, g, w, atol in zip(("C3", "C4", "C5"), got, want, (2e-4, 2e-4, 2e-3)):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=1e-3, err_msg=name)


def test_fused_backbone_matches_eager_backbone(backbones):
    """The folded, fused route gives the port's eager MobileNetV2 taps."""
    _, _, pt = backbones
    images = torch.from_numpy(
        (np.random.default_rng(6).standard_normal((2, SIZE, SIZE, 3)) * 0.5).astype(np.float32))
    with torch.no_grad():
        want = pt(images.permute(0, 3, 1, 2))
    got = fb.fused_mobilenet_backbone(fb.pack_backbone_weights(pt, torch.float32), images)
    for name, g, w, atol in zip(("C3", "C4", "C5"), got, want, (2e-4, 2e-4, 2e-3)):
        np.testing.assert_allclose(g.numpy(), w.permute(0, 2, 3, 1).numpy(), atol=atol,
                                   rtol=1e-3, err_msg=name)


def test_fused_encode_matches_jax():
    """``fused_encode`` → ``Transformer.encode_from_taps`` against JAX
    ``fused_encode(interpret=True)`` on the same perturbed weights."""
    from fpn_mt_image_captioning_tpu.models.positional import create_masks
    from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
    from fpn_mt_image_captioning_torch.models.transformer import Transformer

    size = 256   # the smallest input whose five pyramid views are all non-empty
    kw = dict(num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=(size // 16) ** 2,
              target_vocab_size=40, max_seq_len=8, backbone_name="mobilenet224_0.35")
    jx = JxTransformer(**kw)
    key = jax.random.PRNGKey(2)
    tar = jnp.ones((1, 4), jnp.int32)
    v = perturbed(jax.jit(lambda i, t: jx.init({"params": key, "dropout": key}, i, t, True,
                                                create_masks(t)))(
        jnp.zeros((1, size, size, 3)), tar), 3)
    images = np.random.default_rng(7).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    want = jfb.fused_encode(jx, v, jnp.asarray(images), interpret=True)

    pt = Transformer(**kw).eval()
    pt.load_state_dict(from_flax(v), strict=True)
    packed = fb.pack_backbone_weights(pt.encoder.feature_extractor.backbone, torch.float32)
    with torch.no_grad():
        got = fb.fused_encode(pt, packed, torch.from_numpy(images))
        eager = pt.encode(torch.from_numpy(images))
    assert got.shape == want.shape == (2, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(got.numpy(), eager.numpy(), atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("hw", [(15, 16), (16, 15)], ids=["odd-rows", "odd-cols"])
def test_odd_extents_at_stride_two_raise(alpha1, hw):
    *_, jpacked, packed = alpha1
    blk, meta = packed["blocks"][1]
    assert meta["stride"] == 2
    x = torch.zeros(1, *hw, blk["w_exp"].shape[0])
    with pytest.raises(ValueError, match="even extents"):
        fb.fused_ir_block(x, blk, stride=2, residual=False)
    with pytest.raises(ValueError, match="even extents"):
        fb.fused_ir_block_reference(x, blk, stride=2, residual=False)
    jblk = jpacked["blocks"][1][0]
    with pytest.raises(ValueError, match="even extents"):   # the JAX package refuses too
        jfb.fused_ir_block(jnp.zeros((1, hw[0] + 2, 32, 128)), jblk, stride=2, h_in=hw[0],
                           w_in=hw[1], residual=False, interpret=True)


def _block_plans(alpha, dtype, batch=0):
    """(cin, cout, stride, expand, plan) of every block of a MobileNetV2,
    each planned for ``batch`` images of 512² (0: no pixel count)."""
    packed = fb.pack_backbone_weights(MobileNetV2Backbone(alpha=alpha), torch.float32)
    out, hw = [], 256
    for blk, meta in packed["blocks"]:
        cin = blk["w_exp"].shape[0] if "w_exp" in blk else blk["w_dw"].shape[1]
        expand, stride = "w_exp" in blk, meta["stride"]
        hw //= stride
        out.append((cin, meta["c_out"], stride, expand,
                    fb.tile_plan(cin, meta["c_out"], stride, dtype, expand, batch * hw * hw)))
    return out


def test_tile_plan_fits_every_flagship_block():
    """Every block of mobilenet224_1.0 (the smoke's shapes): float32 gets full
    8-row tiles and one slice of NJ·32 >= Cout channels; bfloat16 one slice,
    8-row tiles where the accumulators allow (4 rows for blocks 13 and 16),
    16-row tiles for the early stride-1 blocks where the image gives 4 tiles
    an SM (blocks 0, 2, 4, 5 at batch 64; 0 and 2 at batch 8), and two blocks
    an SM. A block too wide for the 227 KB of shared memory raises."""
    for cin, cout, stride, _, plan in _block_plans(1.0, torch.float32):
        assert plan.th == 8 and plan.width == 32 * plan.unit >= cout and plan.slices == 1
    plans = _block_plans(1.0, torch.bfloat16)
    assert [p.th for *_, p in plans] == [8] * 13 + [4, 8, 8, 4]
    assert all(p.slices == 1 and p.blocks_per_sm >= 2 for *_, p in plans)
    tall = {b: [i for i, (*_, p) in enumerate(_block_plans(1.0, torch.bfloat16, b)) if p.th == 16]
            for b in (64, 8)}
    assert tall == {64: [0, 2, 4, 5], 8: [0, 2]}
    assert fb.tile_plan(136, 224, 2, torch.float32).th == 4  # alpha 1.4's block_5_0
    with pytest.raises(ValueError, match="shared memory"):
        fb.tile_plan(4096, 64, 2, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        fb.tile_plan(8192, 64, 2, torch.bfloat16)


@pytest.mark.parametrize("alpha", [0.35, 0.5, 0.75, 1.0, 1.4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_tile_plan_every_alpha(alpha, dtype):
    """Every block of MobileNetV2 at each alpha, planned without a pixel
    count and for batch 64 at 512²: a plan within the 227 KB a block may use,
    covering Cout; in bfloat16 one slice, whose shared memory (``_mma_smem``,
    the kernel's sum) leaves room for two blocks an SM, the occupancy the
    tensor-core kernel is built for (``__launch_bounds__(256, 2)``); its
    accumulators, NTW n-tiles of 8 a warp, cover the slice."""
    for batch in (0, 64):
        for cin, cout, stride, expand, plan in _block_plans(alpha, dtype, batch):
            assert plan.smem <= fb.MAX_SMEM and plan.width * plan.slices >= cout
            assert plan.blocks_per_sm == fb.SM_SMEM // (plan.smem + fb.BLOCK_RESERVED)
            if dtype == torch.bfloat16:
                warps_n = 8 // -(-plan.th * 8 // 16)
                assert plan.slices == 1 and plan.blocks_per_sm >= 2
                assert plan.unit in (2, 4, 6, 10) and plan.width == warps_n * plan.unit * 8
                assert (plan.smem, plan.width) == fb._mma_smem(plan.th, stride, cin, plan.unit,
                                                               expand)
            else:
                assert plan.th <= 8


def test_wrapper_refuses_other_devices(alpha1):
    *_, packed = alpha1
    blk, meta = packed["blocks"][2]
    x = torch.zeros(1, 8, 8, 24, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        fb.fused_ir_block(x, blk, stride=1, residual=True)


def test_pipeline_fused_route_matches_eager_route():
    """``Pipeline(fused_backbone=True, device="cpu")`` gives the same tokens as
    the eager encode at float32, on the perturbed weights of the slice test."""
    from test_torch_slice import CFG, MAX_LEN, fit
    from fpn_mt_image_captioning_torch.data.tokenizer import Tokenizer
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

    tok = fit(Tokenizer)
    eager = Pipeline(tok, MAX_LEN, CFG, seed=4, device="cpu")
    fused = Pipeline(tok, MAX_LEN, CFG.replace(fused_backbone=True), seed=4, device="cpu")
    assert eager.backbone_packed is None and fused.backbone_packed is not None
    # make the captions depend on the image: scale the head trunks as the
    # slice test does, in both pipelines alike
    with torch.no_grad():
        for p in (eager, fused):
            fe = p.transformer.encoder.feature_extractor
            for trunk in (fe.regression_trunk, fe.classification_trunk):
                for conv in trunk.children():
                    conv.weight *= 10.0
            p.transformer.final_layer.weight *= 8.0
            p.packed = pack_decoder_weights(p.transformer, p.dtype)
    images = np.random.default_rng(8).integers(0, 256, (3, CFG.image_input_size,
                                                        CFG.image_input_size, 3), np.uint8)
    enc_e, enc_f = eager.encode(images), fused.encode(images)
    np.testing.assert_allclose(enc_f.numpy(), enc_e.numpy(), atol=2e-3, rtol=1e-3)
    a, b = eager.predict_batch(images), fused.predict_batch(images)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
