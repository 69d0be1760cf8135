"""The port's sampling against the JAX package on the CPU: ``_nucleus_keep``
(exact, ties included), the token choice ``sample_tokens`` on the same
Gumbel noise as ``argmax`` of JAX's masked logits plus that noise (exact:
``jax.random.categorical`` is that argmax), ``sample_decode``'s contract on
tests/test_torch_decode_modes.py's small model, and
``Pipeline.sample_batch`` at temperature 0 against the JAX ``Pipeline``.

The random streams of the two packages differ (a ``torch.Generator`` here,
a JAX key there), so whole sampled captions are held to the contract, and
the choice of one step to JAX exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from fpn_mt_image_captioning_tpu.decode import beam_search as jx_bs
from fpn_mt_image_captioning_torch.decode import beam_search as pt_bs
from test_torch_decode_modes import B, END, MAX_LEN, START, VOCAB, small  # noqa: F401

KW = dict(max_len=MAX_LEN, start_token=START, end_token=END)


def jax_keep(probs, top_p):
    return np.asarray(jx_bs._nucleus_keep(jnp.asarray(probs), jnp.asarray(top_p, jnp.float32)))


def port_keep(probs, top_p):
    return pt_bs._nucleus_keep(torch.as_tensor(probs),
                               torch.as_tensor(top_p, dtype=torch.float32)).numpy()


NUCLEUS_CASES = {
    # a tie at the boundary keeps exactly 2; the higher index first among ties
    "boundary_tie": ([[0.5, 0.25, 0.25, 0.0], [0.25, 0.25, 0.5, 0.0]], [0.6, 0.6],
                     [[1, 0, 1, 0], [0, 1, 1, 0]]),
    "all_tied": ([[0.25] * 4, [0.25] * 4], [0.6, 0.3], [[0, 1, 1, 1], [0, 0, 1, 1]]),
    "peaked": ([[0.97, 0.01, 0.01, 0.01]], [0.6], [[1, 0, 0, 0]]),
    "whole_mass": ([[0.5, 0.25, 0.125, 0.125]], [1.0], [[1, 1, 1, 1]]),
    # top_p <= 0 clamps to 1e-9: the top token alone, not nothing
    "zero_and_negative": ([[0.25] * 4, [0.125, 0.5, 0.25, 0.125]], [0.0, -1.0],
                          [[0, 0, 0, 1], [0, 1, 0, 0]]),
}


@pytest.mark.parametrize("case", list(NUCLEUS_CASES))
def test_nucleus_keep_cases(case):
    probs, top_p, want = NUCLEUS_CASES[case]
    probs = np.asarray(probs, np.float32)
    got = port_keep(probs, top_p)
    np.testing.assert_array_equal(got, jax_keep(probs, top_p))
    np.testing.assert_array_equal(got, np.asarray(want, bool))


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_nucleus_keep_forced_ties(data):
    """Rows drawn from few distinct probabilities (so most tie), each a
    multiple of 1/64, so every prefix sum is exact in float32 and the
    packages can differ only in order and threshold, which must agree."""
    rows, v = data.draw(st.integers(1, 4)), data.draw(st.integers(2, 12))
    levels = data.draw(st.lists(st.integers(0, 8), min_size=1, max_size=3))
    probs = np.asarray([[data.draw(st.sampled_from(levels)) for _ in range(v)]
                        for _ in range(rows)], np.float32) / 64
    top_p = np.asarray(data.draw(st.lists(
        st.one_of(st.sampled_from([0.0, 1 / 64, 0.25, 0.5, 1.0]), st.floats(-0.5, 1.5)),
        min_size=rows, max_size=rows)), np.float32)
    np.testing.assert_array_equal(port_keep(probs, top_p), jax_keep(probs, top_p))


def jax_choice(logits, temperature, top_k, top_p, noise):
    """``sample_decode``'s choice as the JAX package's loop body writes it,
    with ``jax.random.categorical``'s Gumbel noise given."""
    logits = jnp.asarray(logits) / jnp.maximum(jnp.asarray(temperature)[:, None], 1e-6)
    if top_k and top_k < logits.shape[-1]:
        kth = jax.lax.top_k(logits, top_k)[0][:, -1:]
        logits = jnp.where(logits < kth, jx_bs.NEG_INF, logits)
    if top_p is not None:
        keep = jx_bs._nucleus_keep(jax.nn.softmax(logits, axis=-1), jnp.asarray(top_p))
        logits = jnp.where(keep, logits, jx_bs.NEG_INF)
    return np.asarray(jnp.argmax(logits + jnp.asarray(noise), axis=-1))


@pytest.mark.parametrize("nucleus", [False, True], ids=["no_top_p", "top_p"])
@pytest.mark.parametrize("top_k", [0, 1, 5, VOCAB])
def test_sample_tokens_on_shared_noise(top_k, nucleus):
    """Per-row temperature (0, 0.5, 1, 3, ...) and top_p: the port's choice
    equals JAX's on the same logits and the same Gumbel noise, over 50
    draws; the logits carry exact ties so top-k keeps values tied with the
    k-th."""
    rng = np.random.default_rng(top_k + 10 * nucleus)
    rows = 8
    logits = rng.standard_normal((rows, VOCAB)).astype(np.float32)
    logits[:, 3:6] = logits[:, :1]                      # ties with each row's first logit
    temperature = np.asarray([0.0, 0.5, 1.0, 3.0, 1.0, 0.7, 2.0, 1e-7], np.float32)
    top_p = np.asarray([0.9, 0.5, 0.95, 0.3, 1.0, 0.0, 0.8, 0.6], np.float32) if nucleus else None
    picked = set()
    for draw in range(50):
        noise = rng.gumbel(size=(rows, VOCAB)).astype(np.float32)
        got = pt_bs.sample_tokens(torch.from_numpy(logits), torch.from_numpy(temperature), top_k,
                                  None if top_p is None else torch.from_numpy(top_p),
                                  torch.from_numpy(noise))
        want = jax_choice(logits, temperature, top_k, top_p, noise)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"draw {draw}")
        picked.update(zip(range(rows), got.tolist()))
    if top_k != 1:
        assert len(picked) > 2 * rows                   # not vacuous: rows sample


@pytest.mark.parametrize("kwargs", [{"temperature": 0.0}, {"temperature": 1e-7}, {"top_k": 1},
                                    {"top_p": 1e-7}, {"top_p": 0.0}],
                         ids=["t0", "t1e-7", "top_k1", "top_p1e-7", "top_p0"])
def test_sample_decode_degenerates_to_jax_greedy(small, kwargs):  # noqa: F811
    jx, params, pt, enc = small
    g_seqs, g_len = jx_bs.greedy_decode(jx, {"params": params}, jnp.asarray(enc), **KW)
    seqs, lengths = pt_bs.sample_decode(pt, torch.from_numpy(enc),
                                        torch.Generator().manual_seed(0), **KW, **kwargs)
    np.testing.assert_array_equal(seqs.numpy(), np.asarray(g_seqs))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(g_len))


def test_sample_decode_seeds(small):  # noqa: F811
    """The same seed gives the same captions; high-temperature captions
    differ between seeds; a per-row near-zero temperature keeps its row
    greedy while the others sample."""
    _, _, pt, enc = small
    enc = torch.from_numpy(enc)

    def run(seed, **kw):
        return pt_bs.sample_decode(pt, enc, torch.Generator().manual_seed(seed), **KW, **kw)[0]

    assert torch.equal(run(7), run(7))
    outs = {run(s, temperature=3.0).numpy().tobytes() for s in range(4)}
    assert len(outs) > 1
    greedy = pt_bs.greedy_decode(pt, enc, **KW)[0]
    mixed = run(11, temperature=np.asarray([1e-7, 3.0, 3.0, 3.0], np.float32))
    assert torch.equal(mixed[0], greedy[0]) and not torch.equal(mixed[1:], greedy[1:])


def test_sample_decode_contract(small, monkeypatch):  # noqa: F811
    """Before the strip a finished row emits pad (0) after its ``<end>``;
    the result is JAX's ``_strip_ended`` of those raw tokens; the loop stops
    at the step where the last row finishes."""
    _, _, pt, enc = small
    raw, steps = [], []
    strip = pt_bs._strip_ended
    monkeypatch.setattr(pt_bs, "_strip_ended",
                        lambda s, t, e: raw.append((s.clone(), t)) or strip(s, t, e))
    step = pt.decode_step
    monkeypatch.setattr(pt, "decode_step", lambda *a, **k: steps.append(1) or step(*a, **k))
    padded = 0
    for seed in range(6):
        raw.clear()
        steps.clear()
        seqs, lengths = pt_bs.sample_decode(pt, torch.from_numpy(enc),
                                            torch.Generator().manual_seed(seed), **KW,
                                            temperature=1.5)
        (tokens, t), = raw
        assert len(steps) == t
        tokens = tokens.numpy()
        ended = (tokens == END).any(1)
        for row in tokens[ended]:
            first = int(np.argmax(row == END))
            assert (row[first + 1: t] == 0).all()
            padded += first + 1 < t
        if t < MAX_LEN:                                 # stopped early: every row ended
            assert ended.all() and (tokens[:, t - 1] == END).any()
        j_seqs, j_len = jx_bs._strip_ended(jnp.asarray(tokens), t, END)
        np.testing.assert_array_equal(seqs.numpy(), np.asarray(j_seqs))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(j_len))
        assert seqs.shape == (B, MAX_LEN) and seqs.dtype == torch.int32
    assert padded   # not vacuous: some row ended before the loop did


def test_sample_batch_zero_temperature_matches_jax(tmp_path):
    """``Pipeline.sample_batch`` at temperature 0, per image, on uint8
    images: JAX's ``sample_batch`` (its greedy decode) exactly; a nucleus
    and top-k setting beside it only runs."""
    from test_torch_decode_modes import port_pipeline
    from test_torch_weight_files import jax_world

    world = jax_world(tmp_path)
    pipe = port_pipeline(world)
    images = world["images"]
    seqs, lengths = pipe.sample_batch(images, seed=3, temperature=np.zeros(len(images)))
    j_seqs, j_len = world["jpipe"].sample_batch(images, seed=3, temperature=0.0)
    np.testing.assert_array_equal(seqs, j_seqs)
    np.testing.assert_array_equal(lengths, j_len)
    assert seqs.dtype == np.int32 and len({tuple(s) for s in seqs}) > 1
    s2, l2 = pipe.sample_batch(images, seed=3, temperature=[0.5, 1.0, 2.0], top_k=5,
                               top_p=[0.9, 1.0, 0.5])
    assert s2.shape == seqs.shape and ((l2 >= 0) & (l2 <= pipe.max_seq_len)).all()
