"""The fused beam search's CUDA-graph route on the card, against its eager
route, bit for bit: a bf16 decoder at the flagship's widths (d 512, 8
heads, dff 2048, vocabulary 2000; 2 layers), beam 8, 30 tokens, at batch 8
and 64. Covered: captions that all end within the first steps (the graph
route's stop test then comes at step 8, after frozen steps), captions of
differing lengths, captions that never end; two shapes interleaved; a
repack, which drops the graphs, and the card memory they held freed
without the cyclic garbage collector; an earlier call's results intact
after later replays; and the ``beam.capture`` / ``beam.replay`` spans and
the launch counters (a capture counts its launches once, a replay none). Needs a CUDA card and nvcc: every test here skips without
one. On the card (no JAX there, so the JAX-side conftest is skipped):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_graphs.py
"""

import gc
from collections import Counter

import pytest
import torch

from fpn_mt_image_captioning_torch.decode import beam_search as bs
from fpn_mt_image_captioning_torch.ops import fused_decoder as fd
from fpn_mt_image_captioning_torch.utils.profiling import REGISTRY

pytestmark = pytest.mark.cuda
MAX_LEN, BEAM, START, END, VOCAB, LENC = 30, 8, 2, 3, 2000, 16
KW = dict(beam_n=BEAM, max_len=MAX_LEN, start_token=START, end_token=END, fused=True)


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.fixture(scope="module")
def model(dev):
    from fpn_mt_image_captioning_torch.models.transformer import Transformer
    from fpn_mt_image_captioning_torch.weights import init_weights

    with torch.device("meta"):
        m = Transformer(2, 512, 8, 2048, 16, VOCAB, max_seq_len=MAX_LEN,
                        backbone_name="mobilenet224_0.35")
    m.to_empty(device="cpu")
    init_weights(m.decoder, torch.Generator().manual_seed(0))
    init_weights(m.final_layer, torch.Generator().manual_seed(1))
    m = bs.cast_for_inference(m.eval(), torch.bfloat16).to(dev)
    m.end_row = m.final_layer.weight[END].clone()
    return m


def encoder_output(batch, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, LENC, 512, generator=g).to(dev, torch.bfloat16)


@torch.no_grad()
def set_ending(model, ending, dev):
    """``<end>``'s row of the vocabulary layer: "full", biased by -30 (no
    caption ends); "early", biased by +30 (every beam ends within the first
    steps); "mixed", reading the embedding of the token the full captions
    emit most, so that a beam ends after it, at steps that differ by item."""
    final = model.final_layer
    final.weight[END] = model.end_row
    final.bias[END] = -30.0
    if ending == "early":
        final.bias[END] = 30.0
    elif ending == "mixed":
        seqs, _, _ = bs.beam_search(model, encoder_output(8, 0, dev), **KW)
        x = Counter(seqs[:, :10].flatten().tolist()).most_common(1)[0][0]
        emb = model.decoder.embedding.weight[x].float()
        final.weight[END] = (8.0 * emb / emb.norm()).to(final.weight.dtype)
        final.bias[END] = -4.0


def eager(model, enc):
    """The eager route: ``packed=None`` packs for the call and holds nothing."""
    return bs.beam_search(model, enc, **KW)


def assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def steps(name):
    return REGISTRY.summary(name).get("steps", 0)


def captured(packed) -> list:
    return [v for v in packed[bs.GRAPHS_KEY]._shapes.values() if isinstance(v, bs._Captured)]


@pytest.mark.parametrize("batch", [8, 64])
@pytest.mark.parametrize("ending", ["early", "mixed", "full"])
def test_graph_route_equals_eager(model, dev, batch, ending):
    """A shape's first call runs eagerly, its second captures one graph a
    position, then every call replays: each result equals the eager
    route's bit for bit. The wrappers count the first call's launches and
    the capture's, one step's a position; a replay counts none."""
    set_ending(model, ending, dev)
    packed = fd.pack_decoder_weights(model, torch.bfloat16)
    encs = [encoder_output(batch, seed, dev) for seed in (1, 2, 3)]
    wants = [eager(model, e) for e in encs]
    lengths = torch.cat([w[1] for w in wants])
    if ending == "full":
        assert (lengths == MAX_LEN).all()
    elif ending == "early":
        assert (lengths < MAX_LEN).all()
    else:
        assert len(set(lengths.tolist())) > 2
    REGISTRY.reset("beam.")
    fd.reset_launch_counts()
    for call in range(4):
        e = encs[call % 3]
        assert_same(bs.beam_search(model, e, packed=packed, **KW), wants[call % 3])
    torch.cuda.synchronize()
    assert steps("beam.capture") == MAX_LEN
    replays = steps("beam.replay")
    assert 3 * bs.STOP_EVERY <= replays <= 3 * MAX_LEN
    if ending == "full":
        assert replays == 3 * MAX_LEN
    if ending == "early":   # the graph route's first stop test, at step 8, ends it
        assert replays == 3 * bs.STOP_EVERY
    issued = steps("beam.kernels") - replays + MAX_LEN   # the eager call's steps, the capture
    assert fd.decoder_logsoftmax_topk.launches == issued
    for k, n in {fd.decoder_linear: 13, fd.decoder_add_layernorm: 6,
                 fd.decoder_self_attention: 2, fd.decoder_cross_attention: 2}.items():
        assert k.launches == n * issued, k.__name__


def test_two_shapes_interleaved(model, dev):
    """Batches of 8 and 64 in turns share one packed weight set: each shape
    captures its own graphs once, and every call equals the eager route."""
    set_ending(model, "mixed", dev)
    packed = fd.pack_decoder_weights(model, torch.bfloat16)
    encs = {b: encoder_output(b, 10 + b, dev) for b in (8, 64)}
    wants = {b: eager(model, e) for b, e in encs.items()}
    REGISTRY.reset("beam.")
    for b in (8, 64, 8, 64, 64, 8):
        assert_same(bs.beam_search(model, encs[b], packed=packed, **KW), wants[b])
    assert steps("beam.capture") == 2 * MAX_LEN
    assert len(captured(packed)) == 2


def test_repack_drops_the_graphs(model, dev):
    """New packed weights (a repack after the weights changed) hold no
    graph of the old ones: their first call runs eagerly on the new
    weights, their second captures anew."""
    set_ending(model, "full", dev)
    enc = encoder_output(8, 5, dev)
    old = fd.pack_decoder_weights(model, torch.bfloat16)
    for _ in range(2):
        bs.beam_search(model, enc, packed=old, **KW)
    bias = model.final_layer.bias
    kept = bias.clone()
    with torch.no_grad():
        bias.add_(torch.linspace(-1, 1, VOCAB, device=dev).to(bias.dtype))
    try:
        new = fd.pack_decoder_weights(model, torch.bfloat16)
        want = eager(model, enc)
        REGISTRY.reset("beam.")
        assert_same(bs.beam_search(model, enc, packed=new, **KW), want)
        assert steps("beam.replay") == 0 and bs.GRAPHS_KEY in new
        assert_same(bs.beam_search(model, enc, packed=new, **KW), want)
        assert steps("beam.capture") == MAX_LEN and steps("beam.replay") == MAX_LEN
        assert not torch.equal(bs.beam_search(model, enc, packed=old, **KW)[2], want[2])
    finally:
        with torch.no_grad():
            bias.copy_(kept)


def test_repack_frees_the_old_graphs(model, dev):
    """Dropping packed weights whose graphs were captured (what a repack
    does to the old ones) frees what the graphs held at once, without the
    cyclic garbage collector: the held buffers (``memory_allocated``) and,
    after ``empty_cache``, the graphs' private pool (``memory_reserved``)."""
    set_ending(model, "full", dev)
    enc = encoder_output(64, 6, dev)
    eager(model, enc)   # what the card keeps after a first call (cuBLAS's workspace) in base
    gc.collect()
    gc.disable()
    try:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        packed = fd.pack_decoder_weights(model, torch.bfloat16)
        for _ in range(2):
            out = bs.beam_search(model, enc, packed=packed, **KW)
        torch.cuda.synchronize()
        [entry] = captured(packed)
        caches = 2 * entry.search.cache["k_self"].nbytes
        assert torch.cuda.memory_allocated(dev) >= base[0] + caches
        del entry, out, packed
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated(dev) == base[0]
        torch.cuda.empty_cache()
        assert torch.cuda.memory_reserved(dev) <= base[1]
    finally:
        gc.enable()


def test_results_stay_intact_after_later_replays(model, dev):
    """The tensors a call returns are its own: later calls on the same
    graphs (other inputs) leave them as they were."""
    set_ending(model, "mixed", dev)
    packed = fd.pack_decoder_weights(model, torch.bfloat16)
    encs = [encoder_output(64, 20 + i, dev) for i in range(4)]
    bs.beam_search(model, encs[0], packed=packed, **KW)
    outs = [bs.beam_search(model, e, packed=packed, **KW) for e in encs]
    torch.cuda.synchronize()
    for out, e in zip(outs, encs):
        assert_same(out, eager(model, e))
    [entry] = captured(packed)
    ptrs = {entry.search.seqs.data_ptr(), entry.search.scores.data_ptr()}
    assert all(a.data_ptr() not in ptrs for out in outs for a in out)
