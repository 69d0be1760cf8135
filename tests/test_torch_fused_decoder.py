"""The port's fused decode step (its plain route, which the CUDA kernels are
held to on the card) against the JAX package's ``fused_decode_step`` run in
the Pallas interpreter — every case of tests/test_fused_decoder.py mirrored,
with the same perturbed weights on both sides and the same inputs. Bar:
scores atol 3e-4, ids equal; the self caches agree too."""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_tpu.models.positional import raw_positional_encoding
from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
from fpn_mt_image_captioning_tpu.ops import fused_decoder as jx_fd
from fpn_mt_image_captioning_torch.models.transformer import Transformer as PtTransformer
from fpn_mt_image_captioning_torch.ops import fused_decoder as pt_fd
from fpn_mt_image_captioning_torch.weights import from_flax

NL, D, H, DFF = 2, 32, 4, 64
ATOL = 3e-4


def perturb(tree, rng):
    """Seeded noise on every leaf (zero/one-initialized biases and LayerNorm
    parameters would hide a packing bug)."""
    if isinstance(tree, Mapping):
        return {k: perturb(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    return a + 0.1 * (a.std() or 1.0) * rng.standard_normal(a.shape).astype(np.float32)


def build(vocab, max_len, b, activation="leaky_relu", seed=0):
    """JAX decoder params (perturbed) and the port model carrying them."""
    jx = JxTransformer(num_layers=NL, d_model=D, num_heads=H, dff=DFF, input_vocab_size=16,
                       target_vocab_size=vocab, max_seq_len=max_len + 1, activation=activation)
    key = jax.random.PRNGKey(seed)
    enc = np.random.default_rng(seed).standard_normal((b, 4, D)).astype(np.float32)
    variables = jx.init({"params": key, "dropout": key}, jnp.asarray(enc),
                        jnp.ones((b, 4), jnp.int32), False, None)
    params = perturb(jax.device_get(variables["params"]), np.random.default_rng(seed + 100))
    with torch.device("meta"):
        pt = PtTransformer(num_layers=NL, d_model=D, num_heads=H, dff=DFF, input_vocab_size=16,
                           target_vocab_size=vocab, max_seq_len=max_len + 1,
                           backbone_name="mobilenet224_0.35", activation=activation)
    pt.to_empty(device="cpu")
    missing, unexpected = pt.load_state_dict(from_flax({"params": params}), strict=False)
    assert not unexpected and all(k.startswith("encoder.") for k in missing)
    return params, pt, enc


def run_case(b, beam, max_len, vocab, steps, reorders=(), scores=None, finished=None,
             topk=None, activation="leaky_relu"):
    """Drive both steps in lock step; reorders: {step: per-beam parent list}."""
    bk = b * beam
    params, pt, enc = build(vocab, max_len, b, activation)
    jpacked = jx_fd.pack_decoder_weights(params, NL, dtype=jnp.float32)
    jcache = jx_fd.init_fused_cache(jpacked, jnp.asarray(enc), beam, max_len)
    ppacked = pt_fd.pack_decoder_weights(pt, torch.float32)
    pcache = pt_fd.init_fused_cache(ppacked, torch.from_numpy(enc), beam, max_len)
    lpad = jcache["k_self"].shape[1]
    assert tuple(pcache["k_self"].shape) == (NL, lpad, bk, D)

    rng = np.random.default_rng(1)
    emb = params["decoder"]["embedding"]["embedding"]
    pe = raw_positional_encoding(max_len + 1, D)
    own = np.arange(bk) % beam
    src = np.broadcast_to(own, (lpad, bk)).astype(np.int32).copy()
    topk = topk or min(5, beam * 4)
    sc = np.zeros((bk, 1), np.float32) if scores is None else np.asarray(scores, np.float32)
    fin = np.zeros((bk, 1), np.float32) if finished is None else np.asarray(finished, np.float32)
    for t in range(steps):
        x_emb = (emb[rng.integers(1, vocab, bk)] + pe[t]).astype(np.float32)
        js, ji, jcache = jx_fd.fused_decode_step(
            jpacked, jcache, jnp.asarray(x_emb), jnp.asarray(src), jnp.int32(t),
            jnp.asarray(sc), jnp.asarray(fin), num_layers=NL, beam=beam, num_heads=H,
            topk=topk, interpret=True, activation=activation)
        ps, pi, pcache = pt_fd.fused_decode_step(
            ppacked, pcache, torch.from_numpy(x_emb), torch.from_numpy(src), t,
            torch.from_numpy(sc), torch.from_numpy(fin), num_layers=NL, beam=beam,
            num_heads=H, topk=topk, activation=activation)
        assert ps.shape == (bk, topk) and pi.dtype == torch.int32
        np.testing.assert_allclose(ps.numpy(), np.asarray(js[:, :topk]), atol=ATOL,
                                   err_msg=f"step {t}")
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ji[:, :topk]), err_msg=f"step {t}")
        if t in reorders:
            parent = np.resize(reorders[t], beam)
            src = src[:, (np.arange(bk) // beam) * beam + np.tile(parent, b)]
        src[t + 1] = own  # identity at the next position (the step's contract)
    np.testing.assert_allclose(pcache["k_self"].numpy(), np.asarray(jcache["k_self"]), atol=ATOL)
    np.testing.assert_allclose(pcache["v_self"].numpy(), np.asarray(jcache["v_self"]), atol=ATOL)
    return pi, pcache, ppacked


def test_multistep_with_reorder():
    run_case(b=2, beam=2, max_len=7, vocab=40, steps=4, reorders={2: [0, 0]})


@pytest.mark.parametrize("activation", sorted(pt_fd.FUSED_ACTIVATIONS))
def test_activation(activation):
    run_case(b=2, beam=2, max_len=7, vocab=40, steps=2, activation=activation)


def test_multichunk_history():
    """max_len 18 → Lpad 24: histories spanning several 8-slot chunks, with
    reorders landing in different chunks."""
    run_case(b=2, beam=2, max_len=18, vocab=40, steps=18,
             reorders={5: [1, 0], 9: [1, 0], 13: [1, 0]}, topk=4)


def test_bk_128():
    run_case(b=16, beam=8, max_len=7, vocab=40, steps=3, reorders={1: [1, 0]}, topk=4)


def test_wide_vocab_scores_and_freeze():
    """Vocab 300 with nonzero running scores and finished rows: a finished
    row's winner is the pad column at exactly its carried score."""
    scores = [[-1.5], [0.25], [-7.0], [3.5]]
    finished = [[0.0], [1.0], [0.0], [1.0]]
    pi, _, _ = run_case(b=2, beam=2, max_len=7, vocab=300, steps=1, scores=scores,
                        finished=finished, topk=2)
    assert np.all(pi.numpy()[[1, 3], 0] == 0)


def test_cache_rows_written_and_rest_zero():
    _, pcache, ppacked = run_case(b=2, beam=2, max_len=7, vocab=40, steps=2)
    k = pcache["k_self"]
    assert torch.count_nonzero(k[:, :2]) > 0 and torch.count_nonzero(k[:, 2:]) == 0
    assert torch.count_nonzero(pcache["v_self"][:, 2:]) == 0


def test_empty_encoder_output_raises():
    """An encoder output of (B, 0, d) — what a 64² input encodes to: the JAX
    package's fused step raises (its cross-attention softmax reduces over no
    position), and the port raises too, at the cache and in both routes of
    the cross-attention, instead of returning scores over an empty context."""
    b, beam, max_len, vocab = 2, 2, 7, 40
    params, pt, _ = build(vocab, max_len, b)
    enc = np.zeros((b, 0, D), np.float32)
    jpacked = jx_fd.pack_decoder_weights(params, NL, dtype=jnp.float32)
    jcache = jx_fd.init_fused_cache(jpacked, jnp.asarray(enc), beam, max_len)
    bk, lpad = b * beam, jcache["k_self"].shape[1]
    src = np.broadcast_to(np.arange(bk) % beam, (lpad, bk)).astype(np.int32)
    x_emb = np.zeros((bk, D), np.float32)
    zeros = jnp.zeros((bk, 1), jnp.float32)
    with pytest.raises(ValueError):
        jx_fd.fused_decode_step(jpacked, jcache, jnp.asarray(x_emb), jnp.asarray(src),
                                jnp.int32(0), zeros, zeros, num_layers=NL, beam=beam,
                                num_heads=H, topk=2, interpret=True)

    ppacked = pt_fd.pack_decoder_weights(pt, torch.float32)
    with pytest.raises(ValueError, match="Lenc = 0"):
        pt_fd.init_fused_cache(ppacked, torch.from_numpy(enc), beam, max_len)
    q, kv_cross = torch.zeros(bk, D), torch.zeros(NL, 0, b, 2 * D)
    for route in (pt_fd.decoder_cross_attention, pt_fd.decoder_cross_attention_reference):
        with pytest.raises(ValueError, match="Lenc = 0"):
            route(q, kv_cross, 0, beam, H)
