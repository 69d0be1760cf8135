"""The port's non-fused decode route against the JAX package on the CPU: the
mask builders, ``attend_cached`` with an ancestry, ``init_cache`` /
``decode_step``, the non-fused fast ``beam_search``, parity mode (natural
weights and the three crafted ties of tests/test_decode.py), ``greedy_decode``;
then ``Pipeline.predict_batch`` with ``beam_parity_mode`` and with
``use_pallas=False``, ``predict_with_attention`` and the figures, against the
JAX ``Pipeline`` on the same weights.

The small model is tests/test_decode.py's (2 layers, d 16, 2 heads, dff 32,
vocabulary 23) with its initial weights perturbed by a numpy seed and the
final layer scaled, so that captions differ by item, some end early and beam
4 differs from greedy. Bars: masks, sequences and lengths exact; float32
values atol 1e-5; bfloat16 caches and logits within 2 bf16 ulp of each row's
largest value, the step run layer by layer on JAX's inputs (JAX's own jitted
and eager bf16 results differ by rounding, so a whole run compounds it)."""

from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_tpu.decode.beam_search import beam_search as jx_beam_search
from fpn_mt_image_captioning_tpu.decode.beam_search import greedy_decode as jx_greedy
from fpn_mt_image_captioning_tpu.models import positional as jx_pos
from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
from fpn_mt_image_captioning_torch.decode import beam_search as pt_bs
from fpn_mt_image_captioning_torch.decode.beam_search import cast_for_inference
from fpn_mt_image_captioning_torch.models import positional as pt_pos
from fpn_mt_image_captioning_torch.models.transformer import Transformer as PtTransformer
from fpn_mt_image_captioning_torch.weights import from_flax

VOCAB, START, END, MAX_LEN, B = 23, 2, 3, 7, 4
ATOL = 1e-5


def perturb(tree, rng):
    if isinstance(tree, Mapping):
        return {k: perturb(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    return a + 0.1 * (a.std() or 1.0) * rng.standard_normal(a.shape).astype(np.float32)


def jax_model(dtype=jnp.float32):
    return JxTransformer(num_layers=2, d_model=16, num_heads=2, dff=32, input_vocab_size=16,
                         target_vocab_size=VOCAB, max_seq_len=MAX_LEN + 1, dtype=dtype)


def port_model(params, dtype=torch.float32):
    """The port's model carrying the JAX decoder ``params`` (its encoder
    weights stay unset: these tests decode from given encoder outputs)."""
    with torch.device("meta"):
        pt = PtTransformer(num_layers=2, d_model=16, num_heads=2, dff=32, input_vocab_size=16,
                           target_vocab_size=VOCAB, max_seq_len=MAX_LEN + 1,
                           backbone_name="mobilenet224_0.35")
    pt.to_empty(device="cpu")
    missing, unexpected = pt.load_state_dict(from_flax({"params": params}), strict=False)
    assert not unexpected and all(k.startswith("encoder.") for k in missing)
    return cast_for_inference(pt.eval(), dtype)


@pytest.fixture(scope="module")
def small():
    """JAX model, its params, the port model and a (B, 4, 16) encoder output."""
    jx = jax_model()
    enc = np.random.default_rng(1).standard_normal((B, 4, 16)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    v = jx.init({"params": key, "dropout": key}, jnp.asarray(enc), jnp.ones((B, 4), jnp.int32),
                False, None)
    params = perturb(jax.device_get(v["params"]), np.random.default_rng(101))
    params["final_layer"]["kernel"] = params["final_layer"]["kernel"] * 2.0
    params["final_layer"]["bias"][END] += 2.0
    return jx, params, port_model(params), enc


def run_both(small, params=None, **kw):
    """JAX's and the port's ``beam_search`` on the same weights and input."""
    jx, p0, pt, enc = small
    params = p0 if params is None else params
    pt = pt if params is p0 else port_model(params)
    common = dict(max_len=MAX_LEN, start_token=START, end_token=END, **kw)
    j = jx_beam_search(jx, {"params": params}, jnp.asarray(enc), **common)
    p = pt_bs.beam_search(pt, torch.from_numpy(enc), **common)
    return [np.asarray(a) for a in j], [a.numpy() for a in p]


def test_create_masks():
    tar = np.random.default_rng(0).integers(0, 4, (3, 6)).astype(np.int32)
    tar[:, 0] = 2
    np.testing.assert_array_equal(pt_pos.create_padding_mask(torch.from_numpy(tar)).numpy(),
                                  np.asarray(jx_pos.create_padding_mask(jnp.asarray(tar))))
    np.testing.assert_array_equal(pt_pos.create_look_ahead_mask(6).numpy(),
                                  np.asarray(jx_pos.create_look_ahead_mask(6)))
    got = pt_pos.create_masks(torch.from_numpy(tar))
    assert got.shape == (3, 1, 6, 6) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jx_pos.create_masks(jnp.asarray(tar))))


@torch.no_grad()
def test_attend_cached_with_ancestry(small):
    """A single-position query over a (B, L, H, D) cache read through a
    random ancestry of global rows, the slots after position 3 masked."""
    jx, params, pt, _ = small
    rng = np.random.default_rng(2)
    lmax = 6
    q = rng.standard_normal((B, 1, 16)).astype(np.float32)
    k, v = (rng.standard_normal((B, lmax, 2, 8)).astype(np.float32) for _ in range(2))
    src = rng.integers(0, B, (B, lmax)).astype(np.int32)
    mask = (np.arange(lmax) > 3).astype(np.float32)[None, :, None]

    def attend(m, *a):
        return m.decoder.dec_layers[0].mha1.attend_cached(*a)

    want = jx.apply({"params": params}, *map(jnp.asarray, (q, k, v, mask, src)), method=attend)
    got = pt.decoder.layer_0.mha1.attend_cached(
        *map(torch.from_numpy, (q, k, v, mask)), src=torch.from_numpy(src).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the ancestry matters: without it the result differs
    plain = pt.decoder.layer_0.mha1.attend_cached(*map(torch.from_numpy, (q, k, v, mask)))
    assert np.abs(plain.numpy() - np.asarray(want)).max() > 1e-3


@torch.no_grad()
def test_decode_step_float32(small):
    """``init_cache`` and four ``decode_step`` calls with random tokens and
    ancestries: logits and every cache at atol 1e-5."""
    jx, params, pt, enc = small
    lmax = MAX_LEN + 1
    variables = {"params": params}
    jc = jx.apply(variables, jnp.asarray(enc), lmax, method=JxTransformer.init_cache)
    pc = pt.init_cache(torch.from_numpy(enc), lmax)
    step = jax.jit(lambda c, tok, t, s: jx.apply(variables, tok, t, c, s,
                                                 method=JxTransformer.decode_step))
    rng = np.random.default_rng(3)
    for t in range(4):
        tok = rng.integers(1, VOCAB, B).astype(np.int32)
        src = rng.integers(0, B, (B, lmax)).astype(np.int32)
        jl, jc = step(jc, jnp.asarray(tok), jnp.int32(t), jnp.asarray(src))
        pl, pc = pt.decode_step(torch.from_numpy(tok).long(), t, pc, torch.from_numpy(src).long())
        assert pl.dtype == torch.float32 and pl.shape == (B, VOCAB)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL, err_msg=f"step {t}")
        for layer, (a, b) in enumerate(zip(jc, pc)):
            for name in ("k_self", "v_self", "k_cross", "v_cross"):
                np.testing.assert_allclose(b[name].numpy(), np.asarray(a[name]), atol=ATOL,
                                           err_msg=f"step {t} layer {layer} {name}")


def within_bf16_ulps(got: torch.Tensor, want, n: int = 2) -> None:
    """|got - want| <= n bf16 ulps of the largest |want| of each row."""
    want = np.asarray(want).astype(np.float32)
    got = got.float().numpy()
    scale = np.maximum(np.abs(want).max(axis=-1, keepdims=True), 1e-30)
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= n * ulp).all(), (np.abs(got - want) / ulp).max()


@torch.no_grad()
def test_decode_step_bfloat16(small):
    """bfloat16 (the card's compute dtype): ``init_cache``'s cross K/V, then
    each layer's ``decode_step`` fed JAX's input and caches (its self caches
    written at position t, a random ancestry) and the vocabulary projection
    of JAX's last hidden state: caches and logits within 2 bf16 ulp."""
    _, params, _, enc = small
    jx, pt = jax_model(jnp.bfloat16), port_model(params, torch.bfloat16)
    variables = {"params": params}
    lmax = MAX_LEN + 1
    bf = lambda a: torch.from_numpy(np.asarray(a).astype(np.float32)).to(torch.bfloat16)
    jenc = jnp.asarray(enc, jnp.bfloat16)
    jc = jx.apply(variables, jenc, lmax, method=JxTransformer.init_cache)
    pc = pt.init_cache(bf(jenc), lmax)
    for a, b in zip(jc, pc):
        for name in ("k_cross", "v_cross"):
            assert b[name].dtype == torch.bfloat16
            within_bf16_ulps(b[name], a[name])
    rng = np.random.default_rng(4)
    for t in range(3):
        src = rng.integers(0, B, (B, lmax)).astype(np.int32)
        h = jnp.asarray(rng.standard_normal((B, 1, 16)), jnp.bfloat16)
        for li, c in enumerate(jc):
            layer = jax.jit(lambda *a, li=li, t=t: jx.apply(
                variables, *a, method=lambda m, *b: m.decoder.dec_layers[li].decode_step(
                    b[0], jnp.int32(t), *b[1:])))
            h_next, jk, jv = layer(h, c["k_self"], c["v_self"], c["k_cross"], c["v_cross"],
                                   jnp.asarray(src))
            _, pk, pv = getattr(pt.decoder, f"layer_{li}").decode_step(
                bf(h), t, bf(c["k_self"]), bf(c["v_self"]), bf(c["k_cross"]),
                bf(c["v_cross"]), torch.from_numpy(src).long())
            within_bf16_ulps(pk, jk)
            within_bf16_ulps(pv, jv)
            jc[li] = dict(c, k_self=jk, v_self=jv)
            h = h_next
        jl = jax.jit(lambda x: jx.apply(variables, x, method=lambda m, y: m.final_layer(y)))(h[:, 0])
        pl = pt.final_layer(bf(h[:, 0])).float()
        within_bf16_ulps(pl, np.asarray(jl, np.float32))


@pytest.mark.parametrize("beam_n", [1, 4])
def test_fast_beam_search_matches_jax(small, beam_n):
    (js, jl, jsc), (ps, pl, psc) = run_both(small, beam_n=beam_n)
    assert ps.dtype == np.int32 and pl.dtype == np.int32
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(psc, jsc, atol=ATOL)
    # not vacuous: some items end early, and beam 4 finds another caption
    # than greedy on some item
    assert pl.min() < MAX_LEN
    if beam_n > 1:
        assert (ps != run_both(small, beam_n=1)[1][0]).any()


def crafted(params, bias):
    """``params`` with a zeroed final kernel and the final bias ``bias``
    (tests/test_decode.py's crafted ties)."""
    out = {k: v for k, v in params.items()}
    out["final_layer"] = {"kernel": np.zeros_like(params["final_layer"]["kernel"]),
                          "bias": bias}
    return out


TIES = {
    # every logit equal: all beams through beam 0, tokens 0..K-1; max_len zeros
    "all_way": ({}, MAX_LEN, 0),
    # tokens 5 and 7 tied at the top: token 5 repeated to max_len
    "two_way": ({5: 1.0, 7: 1.0}, MAX_LEN, 5),
    # <end> tied with 5: the best beam ends at once, an empty caption
    "end_tie": ({END: 1.0, 5: 1.0}, 0, 0),
}


@pytest.mark.parametrize("case", ["natural", *TIES])
def test_parity_mode_matches_jax(small, case):
    """Parity mode exactly as JAX's, on the perturbed weights (where it
    equals JAX's greedy decode) and on the three crafted ties (where it
    gives their pinned outputs)."""
    params = small[1]
    if case != "natural":
        bias = np.zeros(VOCAB, np.float32)
        for tok, val in TIES[case][0].items():
            bias[tok] = val
        params = crafted(params, bias)
    (js, jl, jsc), (ps, pl, psc) = run_both(small, params, beam_n=4, parity=True)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pl, jl)
    np.testing.assert_allclose(psc, jsc, atol=ATOL)
    if case == "natural":
        g_seqs, g_len = jx_greedy(small[0], {"params": params}, jnp.asarray(small[3]),
                                  max_len=MAX_LEN, start_token=START, end_token=END)
        np.testing.assert_array_equal(ps, np.asarray(g_seqs))
        np.testing.assert_array_equal(pl, np.asarray(g_len))
    else:
        _, length, token = TIES[case]
        assert (pl == length).all() and (ps == token).all()


def test_parity_with_fused_route_raises(small):
    _, _, pt, enc = small
    with pytest.raises(ValueError, match="parity"):
        pt_bs.beam_search(pt, torch.from_numpy(enc), beam_n=2, max_len=MAX_LEN,
                          start_token=START, end_token=END, parity=True, fused=True)


def test_greedy_decode_matches_jax(small):
    jx, params, pt, enc = small
    kw = dict(max_len=MAX_LEN, start_token=START, end_token=END)
    js, jl = jx_greedy(jx, {"params": params}, jnp.asarray(enc), **kw)
    ps, pl = pt_bs.greedy_decode(pt, torch.from_numpy(enc), **kw)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))


# ---------------------------------------------------------------------------
# the pipeline, against the JAX Pipeline on the weights of test_torch_slice
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from test_torch_weight_files import jax_world

    return jax_world(tmp_path_factory.mktemp("decode_modes"))


def port_pipeline(world, **cfg):
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

    return Pipeline(world["cfg"].tokenizer_filename, world["jpipe"].max_seq_len,
                    world["cfg"].replace(**cfg), world["variables"], device="cpu")


@pytest.mark.parametrize("cfg", [{"beam_parity_mode": True}, {"use_pallas": False}],
                         ids=["parity", "use_pallas_false"])
def test_pipeline_predict_batch_matches_jax(world, cfg, monkeypatch):
    """Both non-fused routes of ``predict_batch`` on uint8 images equal the
    JAX ``Pipeline.predict_batch`` with the same setting, and neither
    reaches the fused decode step."""
    pipe = port_pipeline(world, **cfg)
    jpipe = world["jpipe"]
    monkeypatch.setattr(jpipe, "config", jpipe.config.replace(**cfg))
    monkeypatch.setattr(pt_bs, "fused_decode_step", None)   # any call would fail
    images = world["images"]
    assert images.dtype == np.uint8
    seqs, lengths = pipe.predict_batch(images)
    j_seqs, j_len = jpipe.predict_batch(images)
    np.testing.assert_array_equal(seqs, j_seqs)
    np.testing.assert_array_equal(lengths, j_len)
    assert len({tuple(s) for s in seqs}) > 1   # not vacuous: captions differ by image


def test_predict_with_attention_matches_jax(world):
    pipe = port_pipeline(world)
    img = world["images"][1]
    seq, att = pipe.predict_with_attention(img)
    j_seq, j_att = world["jpipe"].predict_with_attention(img)
    np.testing.assert_array_equal(seq, j_seq)
    assert list(att) == list(j_att) and len(att) == 2 * 2
    n = min(len(seq) + 1, pipe.max_seq_len)
    for name, want in j_att.items():
        got = att[name]
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.shape[:3] == (1, 4, n)
        np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_figures_written_where_jax_writes_them(world, tmp_path):
    """``plot_attention_weights`` and ``save_fig_png`` write a PNG at the
    path JAX's write theirs (matplotlib imported inside the functions)."""
    from fpn_mt_image_captioning_tpu.utils.figures import save_fig_png as jx_save
    from fpn_mt_image_captioning_torch.utils.figures import save_fig_png as pt_save

    pipe = port_pipeline(world)
    seq, att = pipe.predict_with_attention(world["images"][0])
    tokens = [pipe.start_token, *seq]
    for pkg, obj in (("pt", pipe), ("jx", world["jpipe"])):
        path = tmp_path / pkg / "attention" / "layer2_block2.png"
        obj.plot_attention_weights(att, tokens, tokens, "decoder_layer2_block2", str(path))
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    fmap = np.random.default_rng(0).standard_normal((1, 6, 6, 5)).astype(np.float32)
    got = pt_save(fmap, "c3", out_dir=str(tmp_path / "pt_fig"))
    want = jx_save(fmap, "c3", out_dir=str(tmp_path / "jx_fig"))
    assert got == str(tmp_path / "pt_fig" / "c3.png")
    assert want == str(tmp_path / "jx_fig" / "c3.png")
    assert open(got, "rb").read()[:8] == b"\x89PNG\r\n\x1a\n"
