"""The captioner whose decoder is Kimi-VL-A3B's language model
(``fpn_mt_image_captioning_torch/models/kimi_vl.py``), held on the CPU to the
benchmark's plain float32 reference (``gpubench/reference/kimi_vl.py``:
full recomputation, K/V decompressed, a loop over the experts) at a tiny
size: hidden 64, 4 heads, kv_lora 32, rope 8, 8 experts of which 2 a token,
1 shared expert, 3 layers of which the first is dense, under a tiny FPN-MT
encoder. Both run in float32 here, so each tolerance is float32 rounding
of the same sums taken in another order (absorbed vs decompressed
attention, a grouped product vs a loop), some 1e-6 of the logits' scale."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_torch.config import Config
from fpn_mt_image_captioning_torch.decode import beam_search as bs
from fpn_mt_image_captioning_torch.models import kimi_vl as kv
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from fpn_mt_image_captioning_torch.utils.profiling import REGISTRY
from gpubench import harness, inputs_lm
from gpubench.reference import decode as ref_decode

V, MAX_LEN, BEAM, START, END = 40, 6, 3, 2, 3
TEXT = dict(
    vocab_size=V, max_position_embeddings=131072, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4, n_shared_experts=1,
    n_routed_experts=8, ep_size=1, routed_scaling_factor=2.446, kv_lora_rank=32,
    q_lora_rank=None, qk_rope_head_dim=8, v_head_dim=16, qk_nope_head_dim=16,
    topk_method="noaux_tc", n_group=1, topk_group=1, num_experts_per_tok=2, moe_layer_freq=1,
    first_k_dense_replace=1, norm_topk_prob=True, scoring_func="sigmoid", seq_aux=True,
    num_key_value_heads=4, hidden_act="silu", rms_norm_eps=1e-5, rope_theta=800000,
    rope_scaling=None, attention_bias=False, tie_word_embeddings=False)
ENCODER = dict(image_input_size=256, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
               dff=64, num_heads=2)
CFG = {**ENCODER, **TEXT, "max_seq_len": MAX_LEN,
       "served_weight_scales": {"trunk": 10.0},
       "lm_weight_scales": {"embedding": 1.0, "lm_head": 3.0, "branch": 1.0,
                            "correction_bias": 0.1}}
# Kimi-VL-A3B-Instruct's published text_config
PUBLISHED = dict(
    vocab_size=163840, max_position_embeddings=131072, hidden_size=2048,
    intermediate_size=11264, moe_intermediate_size=1408, num_hidden_layers=27,
    num_attention_heads=16, n_shared_experts=2, n_routed_experts=64, ep_size=1,
    routed_scaling_factor=2.446, kv_lora_rank=512, q_lora_rank=None, qk_rope_head_dim=64,
    v_head_dim=128, qk_nope_head_dim=128, topk_method="noaux_tc", n_group=1, topk_group=1,
    num_experts_per_tok=6, moe_layer_freq=1, first_k_dense_replace=1, norm_topk_prob=True,
    scoring_func="sigmoid", seq_aux=True, num_key_value_heads=16, hidden_act="silu",
    rms_norm_eps=1e-5, rope_theta=800000, rope_scaling=None, attention_bias=False,
    tie_word_embeddings=False)
# float32 both ways (see the module's docstring)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: at these shapes more only
    add synchronisation, and the suite runs in several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    """A float32 pipeline on the CPU and the reference, on the same seeded
    weights (those the benchmark draws, at this size), and 2 images."""
    state = inputs_lm.weights(CFG, 11, "cpu", dtype=torch.float32)
    cfg = Config(**ENCODER, compute_dtype="float32", beam_search_n=BEAM, language_model=TEXT)
    pipe = Pipeline(harness.tokenizer(V), MAX_LEN, cfg, dict(state), device="cpu")
    ref = inputs_lm.reference(CFG, state, "cpu")
    g = torch.Generator().manual_seed(5)
    images = torch.randint(0, 256, (2, 256, 256, 3), generator=g, dtype=torch.uint8).numpy()
    return pipe, ref, images, state


def test_prefill_then_cached_decode_matches_the_full_forward(world):
    """Prefill once an image, then absorbed decode steps through an ancestry
    that reorders the rows every step, against the reference's full forward
    over each row's whole sequence."""
    pipe, ref, images, _ = world
    model = pipe.transformer
    enc = pipe.encode(images)
    b, steps = enc.shape[0], 5
    cache = model.init_beam_cache(enc, BEAM, steps + 1)
    own = torch.arange(b * BEAM)
    src, group = own[:, None].repeat(1, steps + 1), torch.arange(b)[:, None] * BEAM
    seqs = torch.full((b * BEAM, 1), START)
    g = torch.Generator().manual_seed(0)
    for t in range(steps):
        logits, _ = model.decode_step(seqs[:, -1], t, cache, src)
        with torch.no_grad():
            want = ref.logits(enc.repeat_interleave(BEAM, 0), seqs)[:, -1]
        torch.testing.assert_close(logits, want, **TOL)
        rows = (group + torch.randint(0, BEAM, (b, BEAM), generator=g)).reshape(-1)
        src = src[rows]
        src[:, t + 1] = own
        seqs = torch.cat([seqs[rows], torch.randint(4, V, (b * BEAM, 1), generator=g)], 1)


def test_predict_batch_gives_the_reference_beam_search(world):
    """``Pipeline.predict_batch`` (the encoder, the prefill and the cached
    beam search) gives the reference's best captions, and the search's
    scores its best beams' log-probabilities. The seeded ``lm_head`` row of
    ``<end>`` is 0, so every search runs all steps."""
    pipe, ref, images, _ = world
    seqs, lengths = pipe.predict_batch(images)
    with torch.no_grad():
        want, want_scores, _ = ref_decode.beam_search(
            ref, ref.encode(torch.as_tensor(images)), BEAM, MAX_LEN, START, END)
    np.testing.assert_array_equal(lengths, [MAX_LEN] * len(images))
    np.testing.assert_array_equal(seqs, want[:, 0].numpy())
    _, _, scores = bs.beam_search(pipe.transformer, pipe.encode(images), beam_n=BEAM,
                                  max_len=MAX_LEN, start_token=START, end_token=END)
    torch.testing.assert_close(scores, want_scores[:, 0], **TOL)


def test_greedy_sampling_gives_the_reference_greedy_search(world):
    """``sample_batch`` with ``top_k`` 1 on the same cache (one row an image)
    is greedy: the reference's beam search of width 1."""
    pipe, ref, images, _ = world
    seqs, lengths = pipe.sample_batch(images, seed=3, top_k=1)
    with torch.no_grad():
        want, _, _ = ref_decode.beam_search(ref, ref.encode(torch.as_tensor(images)), 1,
                                            MAX_LEN, START, END)
    np.testing.assert_array_equal(seqs, want[:, 0].numpy())
    np.testing.assert_array_equal(lengths, [MAX_LEN] * len(images))


def test_the_router_chooses_by_score_and_bias_and_weighs_by_score():
    tc = dict(TEXT, hidden_size=4, n_routed_experts=4, num_experts_per_tok=2)
    router = kv.Router(tc)
    with torch.no_grad():
        router.weight.copy_(torch.tensor([[3.0, 0, 0, 0], [2.0, 0, 0, 0], [1.0, 0, 0, 0],
                                          [0.0, 0, 0, 0]]))
        router.e_score_correction_bias.copy_(torch.tensor([0.0, 0.0, 0.25, 0.0]))
    x = torch.tensor([[1.0, 0, 0, 0]])
    s = torch.sigmoid(torch.tensor([3.0, 2.0, 1.0, 0.0]))
    w, ids = router(x)
    # s = 0.95, 0.88, 0.73, 0.5: by s alone experts 0 and 1; by s + b expert 2
    # (0.98) outranks 1 (0.88)
    assert sorted(ids[0].tolist()) == [0, 2]
    chosen = s[ids[0]]
    torch.testing.assert_close(w[0], chosen / chosen.sum() * 2.446)


def test_the_published_config_on_meta():
    """The published widths, and 15.96 B parameters in the language model."""
    assert kv.language_model_parameters(PUBLISHED) == 15_960_110_208
    with torch.device("meta"):
        lm = kv.LanguageModel(PUBLISHED)
    shapes = {k: tuple(p.shape) for k, p in lm.named_parameters()}
    assert shapes["embed_tokens.weight"] == shapes["lm_head.weight"] == (163840, 2048)
    assert shapes["layers.0.mlp.gate_proj.weight"] == (11264, 2048)
    attn = "layers.5.self_attn."
    assert shapes[attn + "q_proj.weight"] == (16 * 192, 2048)
    assert shapes[attn + "kv_a_proj_with_mqa.weight"] == (512 + 64, 2048)
    assert shapes[attn + "kv_b_proj.weight"] == (16 * 256, 512)
    assert shapes[attn + "o_proj.weight"] == (2048, 16 * 128)
    assert shapes["layers.26.mlp.experts.gate_up_proj"] == (64, 2 * 1408, 2048)
    assert shapes["layers.26.mlp.experts.down_proj"] == (64, 2048, 1408)
    assert shapes["layers.26.mlp.shared_experts.up_proj.weight"] == (2816, 2048)
    assert shapes["layers.26.mlp.gate.weight"] == (64, 2048)
    assert sum(isinstance(layer.mlp, kv.MoE) for layer in lm.layers) == 26


def test_spans_and_counters(world):
    """A call records its ``lm.prefill`` span once and tallies, on the
    device, the rows each expert computed: in each MoE layer of each decode
    step 2 images × 3 beams × 2 choices over 8 experts, in the prefill the
    images' prefix rows."""
    pipe, _, images, _ = world
    REGISTRY.reset("lm.", "moe.")
    pipe.predict_batch(images)
    assert REGISTRY.summary("lm.prefill")["steps"] == 1
    rows = REGISTRY.summary("moe.rows")
    assert rows["tallies"] == (MAX_LEN - 1) * 2
    assert rows["mean"] == pytest.approx(2 * BEAM * 2 / 8)
    prefix = pipe.encode(images).shape[1] + 1
    prefill = REGISTRY.summary("moe.prefill_rows")
    assert prefill["tallies"] == 2 and prefill["mean"] == pytest.approx(2 * prefix * 2 / 8)
    assert {"lm.prefill", "moe.rows", "moe.prefill_rows"} <= set(REGISTRY.names())


def test_a_seeded_init_captions(world):
    """Without weights the pipeline draws its own (the encoder's as the
    transformer's, the language model's on the device) and captions."""
    _, _, images, _ = world
    cfg = Config(**ENCODER, compute_dtype="float32", beam_search_n=BEAM, language_model=TEXT)
    pipe = Pipeline(harness.tokenizer(V), MAX_LEN, cfg, device="cpu", seed=4)
    seqs, lengths = pipe.predict_batch(images)
    assert seqs.shape == (len(images), MAX_LEN) and ((seqs >= 0) & (seqs < V)).all()
    assert ((lengths >= 0) & (lengths <= MAX_LEN)).all()


def test_training_is_refused(world, tmp_path):
    pipe, _, images, state = world
    cfg = pipe.config
    with pytest.raises(NotImplementedError, match="does not fit one card"):
        Pipeline(harness.tokenizer(V), MAX_LEN, cfg, dict(state), device="cpu",
                 checkpoint_path=str(tmp_path))
    with pytest.raises(NotImplementedError, match="does not fit one card"):
        pipe.train_step(images, np.ones((len(images), MAX_LEN), np.int32))
    with pytest.raises(NotImplementedError, match="weight files do not hold it"):
        Pipeline(harness.tokenizer(V), MAX_LEN, cfg, {"params": {}}, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_expansion_is_the_flat_stable_top_k(dtype):
    """``_top_wide`` gives the flat stable sort's scores, parents and tokens,
    with ties among a row's best logits (bfloat16 makes many), finished
    rows and a dead beam."""
    b, k, v = 4, 3, 5000
    g = torch.Generator().manual_seed(1)
    logits = (torch.randn(b * k, v, generator=g) * 3).to(dtype)
    logits[0, 10] = logits[0, 20] = logits[0].max()     # a tie at the top
    scores = torch.randn(b, k, generator=g)
    scores[1, 1:] = bs.NEG_INF
    finished = torch.rand(b, k, generator=g) < 0.3
    finished[2] = True
    got = bs._top_wide(logits, scores, finished, k)
    lp = torch.log_softmax(logits.float(), -1).reshape(b, k, v)
    pad = torch.full((v,), bs.NEG_INF)
    pad[0] = 0.0
    total = scores[..., None] + torch.where(finished[..., None], pad, lp)
    want_scores, flat = bs._top(total.reshape(b, k * v), k)
    torch.testing.assert_close(got[0], want_scores, rtol=0, atol=1e-5)   # lse vs log_softmax
    torch.testing.assert_close(got[1], flat // v, rtol=0, atol=0)
    torch.testing.assert_close(got[2], flat % v, rtol=0, atol=0)
