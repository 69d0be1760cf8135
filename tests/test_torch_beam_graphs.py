"""The fused beam search's step body and its CUDA-graph route, on the CPU.

The graph route (``decode/beam_search.py``: held buffers, one graph a
position, the stop test every ``STOP_EVERY`` steps) runs only on the card;
here its loop is driven with the step body run uncaptured in place of each
replay (``Uncaptured``), which is what a graph replays, on an encoder
output that says it lies on the card (``OnCard``). Checked: the step
body, held or fresh, against the JAX package's beam search and the per-step
loop, with captions that end early and captions that never end at two
batch/beam shapes; the graph loop against the per-step loop bit for bit;
which calls the engagement rule sends to the eager path; the shapes a
packed weight set keeps, and that its graphs go with it; and the
benchmark's reader of the graph share.

The model is tests/test_torch_decode_modes.py's small decoder (2 layers,
d 16, 2 heads, dff 32, vocabulary 23), its weights perturbed by a seed,
decoding 19 tokens so that the stop test of the graph route runs twice."""

import functools
import gc
import importlib.util
import os
import sys
import threading
import types
import weakref
from collections.abc import Mapping
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_tpu.decode.beam_search import beam_search as jx_beam_search
from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
from fpn_mt_image_captioning_torch.decode import beam_search as bs
from fpn_mt_image_captioning_torch.models.transformer import Transformer as PtTransformer
from fpn_mt_image_captioning_torch.ops.fused_decoder import pack_decoder_weights
from fpn_mt_image_captioning_torch.utils import profiling
from fpn_mt_image_captioning_torch.utils.profiling import REGISTRY
from fpn_mt_image_captioning_torch.weights import from_flax

VOCAB, START, END, MAX_LEN = 23, 2, 3, 19
READER = Path(__file__).resolve().parents[1] / "gpubench/metrics/decode_graph_share.caption.py"


def perturb(tree, rng):
    if isinstance(tree, Mapping):
        return {k: perturb(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    return a + 0.1 * (a.std() or 1.0) * rng.standard_normal(a.shape).astype(np.float32)


def port_model(params):
    with torch.device("meta"):
        pt = PtTransformer(num_layers=2, d_model=16, num_heads=2, dff=32, input_vocab_size=16,
                           target_vocab_size=VOCAB, max_seq_len=MAX_LEN + 1,
                           backbone_name="mobilenet224_0.35")
    pt.to_empty(device="cpu")
    pt.load_state_dict(from_flax({"params": params}), strict=False)
    return pt.eval()


@pytest.fixture(scope="module")
def models():
    """Per ending, the JAX model, its params and the port's model on them.
    "early": ``<end>``'s logit reads the embedding of token 8, so a beam
    ends after it has emitted 8, at steps that differ by item (0 to 3, and
    some items never); "never": ``<end>`` biased by -30, every caption 19
    tokens long."""
    torch.set_num_threads(1)
    jx = JxTransformer(num_layers=2, d_model=16, num_heads=2, dff=32, input_vocab_size=16,
                       target_vocab_size=VOCAB, max_seq_len=MAX_LEN + 1)
    enc = np.zeros((2, 4, 16), np.float32)
    key = jax.random.PRNGKey(1)
    v = jax.jit(lambda: jx.init({"params": key, "dropout": key}, jnp.asarray(enc),
                                jnp.ones((2, 4), jnp.int32), False, None))()   # 2x eager's speed
    out = {}
    for ending in ("early", "never"):
        params = perturb(jax.device_get(v["params"]), np.random.default_rng(101))
        final = params["final_layer"]
        final["kernel"] = final["kernel"] * 2.0
        if ending == "early":
            emb = params["decoder"]["embedding"]["embedding"][8]
            final["kernel"][:, END] = 12.0 * emb / np.linalg.norm(emb)
            final["bias"][END] = -2.0
        else:
            final["bias"][END] -= 30.0
        out[ending] = (jx, params, port_model(params))
    return out


class OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card (``is_cuda``), which is
    what the engagement rule reads; what is computed from it is a plain CPU
    tensor, so the kernel wrappers run their plain versions."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


def encoder_output(batch: int, seed: int = 0) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((batch, 4, 16))
                            .astype(np.float32))


def on_card(batch: int, seed: int = 0) -> torch.Tensor:
    return encoder_output(batch, seed).as_subclass(OnCard)


KW = dict(max_len=MAX_LEN, start_token=START, end_token=END)


def per_step(model, packed, enc, beam_n, held, steps=False):
    """The fused step body under the per-step loop, its state held in place
    or rebound fresh each step: the result (and the steps it ran)."""
    search = bs._FusedBeams(model, packed, bs._tables(model, torch.float32, enc.device), enc,
                            beam_n=beam_n, held=held, **KW)
    t = bs._run_steps(search, MAX_LEN, False)
    return (search.result(t), t) if steps else search.result(t)


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("batch,beam_n", [(4, 4), (3, 2)])
@pytest.mark.parametrize("ending", ["early", "never"])
def test_step_body_matches_jax(models, ending, batch, beam_n):
    """Held or fresh, the step body gives the present route's result
    (``beam_search(fused=True)`` without held weights) bit for bit, and the
    JAX package's sequences and lengths (scores at atol 1e-5)."""
    jx, params, pt = models[ending]
    enc = encoder_output(batch)
    packed = pack_decoder_weights(pt, torch.float32)
    want = bs.beam_search(pt, enc, beam_n=beam_n, fused=True, **KW)
    for held in (False, True):
        assert_same(per_step(pt, packed, enc, beam_n, held), want)
    js, jl, jsc = jx_beam_search(jx, {"params": params}, jnp.asarray(enc.numpy()),
                                 beam_n=beam_n, **KW)
    np.testing.assert_array_equal(want[0].numpy(), np.asarray(js))
    np.testing.assert_array_equal(want[1].numpy(), np.asarray(jl))
    np.testing.assert_allclose(want[2].numpy(), np.asarray(jsc), atol=1e-5)
    if ending == "never":
        assert (want[1] == MAX_LEN).all()
    else:   # not vacuous: captions end early, at different steps
        assert want[1].max() < MAX_LEN and len(set(want[1].tolist())) > 1


class Uncaptured(bs._Captured):
    """The graph route with each graph's replay running its step body
    uncaptured (what the graph holds), on the CPU."""

    made = 0

    def __init__(self, search):
        Uncaptured.made += 1
        super().__init__(search)

    def _capturing(self):
        return bs._no_span("")

    def _ordered(self):
        return bs._no_span("")

    def _capture(self, t):
        return types.SimpleNamespace(replay=functools.partial(self.search.step, t,
                                                              span=bs._no_span))


def captured(packed) -> list:
    """The shapes of ``packed`` whose graphs were captured, and the graphs."""
    return [(k, v) for k, v in packed[bs.GRAPHS_KEY]._shapes.items()
            if isinstance(v, bs._Captured)]


@pytest.fixture
def graph_route(monkeypatch):
    """Graphs are ``Uncaptured`` (the tests pass ``OnCard`` encoder outputs)."""
    monkeypatch.setattr(bs, "_Captured", Uncaptured)
    Uncaptured.made = 0
    REGISTRY.reset("beam.")
    yield
    REGISTRY.reset("beam.")


def steps(name):
    return REGISTRY.summary(name).get("steps", 0)


@pytest.mark.parametrize("ending", ["early", "never"])
def test_graph_loop_equals_per_step_loop(models, graph_route, ending):
    """The second and later calls of a shape run the graph loop: one
    capture a position, one replay a step, a stop test before steps 8 and
    16 only; the result equals the per-step loop's bit for bit, in fresh
    tensors, and a later call leaves an earlier result intact."""
    _, _, pt = models[ending]
    packed = pack_decoder_weights(pt, torch.float32)
    beam_n, batch = 4, 3
    encs = [on_card(batch, seed) for seed in range(3)]
    wants, eager = zip(*(per_step(pt, packed, e, beam_n, False, steps=True) for e in encs))
    if ending == "early":   # not vacuous: one search ends early, one runs to the end
        assert min(eager) < bs.STOP_EVERY and max(eager) == MAX_LEN
    REGISTRY.reset("beam.")
    first = bs.beam_search(pt, encs[0], beam_n=beam_n, fused=True, packed=packed, **KW)
    assert_same(first, wants[0])
    assert steps("beam.replay") == 0 and Uncaptured.made == 0
    outs = [bs.beam_search(pt, e, beam_n=beam_n, fused=True, packed=packed, **KW)
            for e in encs]
    kept = [tuple(a.clone() for a in o) for o in outs]
    [(_, entry)] = captured(packed)
    held = {entry.search.seqs.data_ptr(), entry.search.scores.data_ptr()}
    for out, copy, want in zip(outs, kept, wants):
        assert_same(out, want)
        assert_same(copy, out)
        assert not {a.data_ptr() for a in out} & held
    assert Uncaptured.made == 1 and steps("beam.capture") == MAX_LEN
    # the graph loop runs on to the next stop test, every STOP_EVERY steps
    every = bs.STOP_EVERY
    ran = [min(MAX_LEN, -(-t // every) * every) for t in eager]
    tests = sum(len([m for m in range(every, r + 1, every) if m < MAX_LEN]) for r in ran)
    assert steps("beam.replay") == sum(ran)
    assert steps("beam.kernels") == eager[0] + sum(ran)   # the first call's eager steps too
    assert steps("beam.issue") == eager[0] + sum(ran)
    assert steps("beam.sync") == eager[0] + (eager[0] < MAX_LEN) + tests


def test_graph_loop_with_fixed_steps(models, graph_route):
    """``fixed_steps`` on the graph route: all steps, no stop test."""
    _, _, pt = models["early"]
    packed, enc = pack_decoder_weights(pt, torch.float32), on_card(2)
    want = per_step(pt, packed, enc, 2, held=False)
    REGISTRY.reset("beam.")
    for _ in range(2):
        got = bs.beam_search(pt, enc, beam_n=2, fused=True, packed=packed, fixed_steps=True,
                             **KW)
        assert_same(got, want)
    assert steps("beam.replay") == MAX_LEN and steps("beam.sync") == 0


ROUTES = {
    "cpu": dict(fused=True),
    "no_packed": dict(fused=True, packed=None),
    "parity": dict(parity=True),
    "non_fused": dict(fused=False),
    "export": dict(fused=True),
}


@pytest.mark.parametrize("case", sorted(ROUTES) + ["first_sighting"])
def test_engagement(models, monkeypatch, case):
    """Graphs engage only on the fused route, not in parity mode, on the
    card, with the caller's packed weights, outside ``torch.export``'s
    trace, and from a shape's second call on; every other call takes the
    eager path, and the result is the same."""
    _, _, pt = models["early"]
    packed = pack_decoder_weights(pt, torch.float32)
    enc = encoder_output(2) if case in ("cpu", "export") else on_card(2)
    monkeypatch.setattr(bs, "_Captured", Uncaptured)
    Uncaptured.made = 0
    kw = dict(KW, beam_n=2, packed=packed)
    kw.update(ROUTES.get(case, dict(fused=True)))
    if case == "export":    # traced once: a shape it recorded would hold graphs next time
        kw["max_len"] = 3

        class Search(torch.nn.Module):
            def forward(self, e):
                return bs.beam_search(pt, e, fixed_steps=True, **kw)

        program = torch.export.export(Search(), (enc,), strict=False)
        assert bs.GRAPHS_KEY not in packed and Uncaptured.made == 0
        assert_same(program.module()(enc), bs.beam_search(pt, enc, **dict(kw, packed=None)))
        return
    want = bs.beam_search(pt, enc, **dict(kw, packed=None))
    for call in range(3):
        assert_same(bs.beam_search(pt, enc, **kw), want)
        if case == "first_sighting":
            assert Uncaptured.made == min(call, 1)
    if case != "first_sighting":
        assert Uncaptured.made == 0
    # a new shape is a first sighting again
    if case == "first_sighting":
        bs.beam_search(pt, on_card(3), **kw)
        assert Uncaptured.made == 1


def test_concurrent_calls(models, graph_route):
    """More threads than cores sharing one packed weight set after a
    shape's first call: its graphs are made once, a call finding them
    being captured or in use runs eagerly, and every result equals the
    per-step loop's."""
    _, _, pt = models["early"]
    packed = pack_decoder_weights(pt, torch.float32)
    encs = [on_card(2, seed) for seed in range(3)]
    wants = [per_step(pt, packed, e, 2, held=False) for e in encs]
    bs.beam_search(pt, encs[0], beam_n=2, fused=True, packed=packed, **KW)
    failures = []

    def caller(i):
        try:
            got = bs.beam_search(pt, encs[i % 3], beam_n=2, fused=True, packed=packed, **KW)
            if not all(torch.equal(g, w) for g, w in zip(got, wants[i % 3])):
                failures.append(i)
        except Exception as e:   # noqa: BLE001 (reported below, with the thread's index)
            failures.append((i, repr(e)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range((os.cpu_count() or 1) + 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not failures
    assert Uncaptured.made == 1 and steps("beam.replay") > 0


def test_a_packed_weight_set_keeps_four_shapes(models, graph_route):
    """A packed weight set remembers the last ``GRAPH_SHAPES`` shapes called,
    seen or captured: a shape past them pushes out the least recently used;
    a pushed-out shape is a first call again, captured on its next; shapes
    that come round less often than that never capture; a new packing holds
    no graph of the old one's."""
    _, _, pt = models["never"]
    packed = pack_decoder_weights(pt, torch.float32)
    run = lambda b: bs.beam_search(pt, on_card(b), beam_n=1, fused=True, packed=packed, **KW)
    for b in range(1, bs.GRAPH_SHAPES + 2):
        run(b), run(b)
    assert Uncaptured.made == bs.GRAPH_SHAPES + 1
    assert [k[0] for k, _ in captured(packed)] == list(range(2, bs.GRAPH_SHAPES + 2))
    run(1)
    assert Uncaptured.made == bs.GRAPH_SHAPES + 1
    run(1)
    assert Uncaptured.made == bs.GRAPH_SHAPES + 2 and captured(packed)[-1][0][0] == 1
    cycle = range(10, 11 + bs.GRAPH_SHAPES)
    for b in [*cycle, *cycle]:
        run(b)
    assert Uncaptured.made == bs.GRAPH_SHAPES + 2 and not captured(packed)
    assert bs.GRAPHS_KEY not in pack_decoder_weights(pt, torch.float32)


def test_old_graphs_go_with_their_packed_weights(models, graph_route):
    """Nothing the graphs hold refers back to the packed weights, so a
    repack's old graphs and held buffers are freed when the old packed
    weights are dropped, without the cyclic garbage collector."""
    _, _, pt = models["never"]
    packed = pack_decoder_weights(pt, torch.float32)
    enc = on_card(2)
    gc.collect()
    gc.disable()
    try:
        for _ in range(2):
            out = bs.beam_search(pt, enc, beam_n=2, fused=True, packed=packed, **KW)
        [(_, entry)] = captured(packed)
        refs = [weakref.ref(o) for o in (packed[bs.GRAPHS_KEY], entry, entry.search,
                                         entry.search.cache["k_self"])]
        del entry, out
        packed = pack_decoder_weights(pt, torch.float32)
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        gc.enable()


def test_graph_share_reader(monkeypatch):
    """``decode_graph_share.caption``: 100 × ``beam.replay`` spans over
    ``beam.kernels`` spans; None without the registry, or where no step
    replayed a graph."""
    spec = importlib.util.spec_from_file_location("graph_share_reader", READER)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    REGISTRY.reset("beam.")
    try:
        assert reader.read({}) is None
        start = profiling._clock()
        for _ in range(4):
            REGISTRY.record("beam.kernels", start, start + 1000)
        assert reader.read({}) is None
        for _ in range(3):
            REGISTRY.record("beam.replay", start, start + 1000)
        assert reader.read({}) == 75.0
        with monkeypatch.context() as m:
            m.delattr(profiling, "REGISTRY")
            assert reader.read({}) is None
    finally:
        REGISTRY.reset("beam.")
