"""The fused decode step's CUDA kernels against their plain PyTorch versions
on the card, at the step's own linear and LayerNorm shapes (batch 8 and 64)
and at small and ragged shapes that the flagship smoke run does not reach
(odd M/N/K, every tile and split plan of the wgmma linear; attention at
head widths 2, 10, 128, 129, 160, 256 and 320, positions 0 and Lpad - 1,
ancestries shared and distinct, beam 1, Lenc 1 to 100, ragged row groups,
pointers off a 16-byte boundary; top-k at vocabularies of 7 to 13000, topk
up to 128, exact ties and totals that rounding ties; the backbone block at
every flagship shape and its occupancy), CUDA-graph captures, a split-K product run twice and the wgmma
linear's phase stamps; and ``Pipeline.evaluate`` on a tiny synthetic split
against the CPU route. Needs a CUDA card and nvcc: every test here
skips on a machine without one. On the card (which has no JAX, so
the JAX-side conftest is skipped):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_kernels.py

Tolerances: float32 atol 1e-4 (accumulation order only); bfloat16
|err| <= 1e-2 + 1e-2·|plain| (one bf16 rounding of the result).
"""

import pytest
import torch

from fpn_mt_image_captioning_torch.ops import fused_decoder as fd

pytestmark = pytest.mark.cuda
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def rand(g, *shape, scale=1.0, dtype=torch.float32, dev="cuda"):
    return (torch.randn(*shape, generator=g) * scale).to(dev, dtype)


def assert_close(got, want, dtype):
    got, want = got.float(), want.float()
    tol = 1e-4 if dtype == torch.float32 else 1e-2 + 1e-2 * want.abs()
    err = (got - want).abs()
    assert torch.isfinite(got).all() and bool((err <= tol).all()), float(err.max())


# (K, N) of the decode step's linears at d 512, dff 2048, vocabulary 2000:
# QKV, the three d→d projections (out, cross q, cross out), FFN1, FFN2, vocab
STEP_KN = [(512, 1536), (512, 512), (512, 2048), (2048, 512), (512, 2000)]
LINEAR_SHAPES = ([(5, 24, 40), (64, 512, 136), (130, 100, 36), (1, 8, 8), (100, 512, 512),
                  (100, 24, 40), (7, 24, 1536)]
                 + [(m, k, n) for m in (64, 512) for k, n in STEP_KN])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", LINEAR_SHAPES)
@pytest.mark.parametrize("act,out_f32", [("none", True), ("none", False), ("leaky_relu", False),
                                         ("gelu", False), ("relu6", True), ("relu", False)])
def test_linear(dev, dtype, m, k, n, act, out_f32):
    g = torch.Generator().manual_seed(m * 7 + n)
    x, w = rand(g, m, k, dtype=dtype), rand(g, k, n, scale=k ** -0.5, dtype=dtype)
    b = rand(g, n, scale=0.5)
    before = fd.decoder_linear.launches
    got = fd.decoder_linear(x, w, b, act, out_f32)
    assert fd.decoder_linear.launches == before + 1
    assert got.dtype == (torch.float32 if out_f32 else dtype)
    assert_close(got, fd.decoder_linear_reference(x, w, b, act, out_f32), dtype)


@pytest.mark.parametrize("m,k,n", [(5, 24, 40), (100, 512, 512), (512, 2048, 512), (1, 8, 8),
                                   (130, 1000, 200)])
@pytest.mark.parametrize("bm,split", [(64, 1), (64, 2), (128, 1), (128, 2), (64, 8), (128, 8)])
def test_linear_plans(dev, m, k, n, bm, split):
    """Every tile height and split of the wgmma kernel on ragged shapes
    (the default plan reaches only some); a split that does not divide K's
    slices raises before anything launches."""
    g = torch.Generator().manual_seed(m + k + bm + split)
    x = rand(g, m, k, dtype=torch.bfloat16)
    w, b = rand(g, k, n, scale=k ** -0.5, dtype=torch.bfloat16), rand(g, n, scale=0.5)
    before = fd.decoder_linear.launches
    try:
        plan = fd.linear_plan(m, n, k, bm=bm, split=split)
    except ValueError:
        assert (-(-k // 64)) % split
        return
    got = fd.decoder_linear(x, w, b, "gelu", False, plan=plan)
    assert fd.decoder_linear.launches == before + 1
    assert_close(got, fd.decoder_linear_reference(x, w, b, "gelu", False), torch.bfloat16)


def test_linear_split_k_is_deterministic(dev):
    """A split-K product (batch 8's FFN2: 8 output tiles, K over 8 CTAs) is
    bitwise the same on every run: the partials add up in a fixed order."""
    g = torch.Generator().manual_seed(8)
    x = rand(g, 64, 2048, dtype=torch.bfloat16)
    w, b = rand(g, 2048, 512, scale=2048 ** -0.5, dtype=torch.bfloat16), rand(g, 512)
    assert fd.linear_plan(64, 512, 2048).split > 1
    first = fd.decoder_linear(x, w, b, out_f32=True)
    for _ in range(3):
        assert torch.equal(fd.decoder_linear(x, w, b, out_f32=True), first)
    assert_close(first, fd.decoder_linear_reference(x, w, b, out_f32=True), torch.bfloat16)


def test_linear_phase_times(dev):
    """The phase-stamping build (scripts/linear_phases.py) computes the same
    product and stamps every CTA of a split launch, each phase in order."""
    from fpn_mt_image_captioning_torch.scripts import linear_phases as lp

    g = torch.Generator().manual_seed(5)
    x = rand(g, 64, 2048, dtype=torch.bfloat16)
    w, b = rand(g, 2048, 512, scale=2048 ** -0.5, dtype=torch.bfloat16), rand(g, 512)
    mod, plan = lp.phases_decoder(), fd.linear_plan(64, 512, 2048)
    assert plan.split > 1
    got = lp.phase_times(mod, x, w, b, "none", True, plan)
    assert got["ctas"] == plan.split * plan.grid_n * plan.grid_m
    phases = got["phases_ns_median_max"]
    assert set(phases) == set(lp.PHASES)
    assert all(0 <= med <= top for med, top in phases.values())
    assert phases["total"][0] > 0 and got["span_ns"] > 0
    assert_close(mod.decoder_linear(x, w, b, out_f32=True, plan=plan),
                 fd.decoder_linear_reference(x, w, b, out_f32=True), torch.bfloat16)


def test_linear_and_layernorm_in_cuda_graph(dev):
    """One linear and one add + LayerNorm captured in a CUDA graph; each
    replay recomputes them from the inputs' current values."""
    g = torch.Generator().manual_seed(3)
    x = rand(g, 512, 512, dtype=torch.bfloat16)
    w, b = rand(g, 512, 512, scale=512 ** -0.5, dtype=torch.bfloat16), rand(g, 512)
    r = rand(g, 512, 512, dtype=torch.bfloat16)
    gamma, beta = 1 + rand(g, 512, scale=0.2), rand(g, 512, scale=0.2)
    run = lambda: fd.decoder_add_layernorm(fd.decoder_linear(x, w, b, out_f32=True), r, gamma,
                                           beta, torch.bfloat16)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_f, out_t = run()
    for seed in range(3):
        x.copy_(rand(torch.Generator().manual_seed(seed), 512, 512, dtype=torch.bfloat16))
        graph.replay()
        torch.cuda.synchronize()
        y = fd.decoder_linear_reference(x, w, b, out_f32=True)
        want_f, want_t = fd.decoder_add_layernorm_reference(y, r, gamma, beta, torch.bfloat16)
        assert_close(out_f, want_f, torch.bfloat16)
        assert_close(out_t, want_t, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(3, 32), (17, 512), (2, 1000), (512, 512), (64, 512),
                                    (5, 1024), (6, 384)])
@pytest.mark.parametrize("r_f32", [False, True])
def test_add_layernorm(dev, dtype, rows, d, r_f32):
    g = torch.Generator().manual_seed(rows + d)
    y = rand(g, rows, d, scale=3)
    r = rand(g, rows, d, dtype=torch.float32 if r_f32 else dtype)
    gamma, beta = 1 + rand(g, d, scale=0.2), rand(g, d, scale=0.2)
    got_f, got_t = fd.decoder_add_layernorm(y, r, gamma, beta, dtype)
    want_f, want_t = fd.decoder_add_layernorm_reference(y, r, gamma, beta, dtype)
    assert_close(got_f, want_f, torch.float32)
    assert_close(got_t, want_t, dtype)


def _ancestry(g, kind, lpad, b, beam, dev):
    """src_t (lpad, b·beam) int32: "random" parents in [0, beam); "shared",
    all beams of an item on one parent a position; "distinct", the beams of
    an item on a permutation of the item's rows a position."""
    if kind == "random":
        src = torch.randint(0, beam, (lpad, b * beam), generator=g)
    elif kind == "shared":
        src = torch.randint(0, beam, (lpad, b, 1), generator=g).expand(lpad, b, beam)
    else:
        src = torch.argsort(torch.rand(lpad, b, beam, generator=g), dim=-1)
    return src.reshape(lpad, b * beam).to(dev, torch.int32)


def _misaligned(t):
    """A contiguous copy of ``t`` that starts one element past a 16-byte
    boundary: the kernels take their 4-value path for it."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


# (d, h, beam, b, lpad, pos, ancestry, misaligned): positions 0, 1, 7 of the
# small shapes; position 0 and Lpad - 1 at Lpad 64; past one staged block of
# ancestry (64 positions); head width 128, 10 (not a multiple of 8) and 2
# (64 heads); beam 1; ancestries shared and distinct; row counts that are not
# a multiple of the block's 8 rows (15, 9, 20); q/k_t/v_t off a 16-byte boundary
SELF_ATTENTION_CASES = (
    [(d, h, beam, b, 8, pos, "random", False)
     for d, h, beam, b in [(32, 4, 3, 4), (256, 2, 2, 3), (64, 8, 1, 5)] for pos in (0, 1, 7)]
    + [(512, 8, 8, 4, 64, 0, "random", False), (512, 8, 8, 4, 64, 63, "random", False),
       (64, 2, 4, 3, 80, 70, "random", False), (256, 2, 8, 3, 64, 40, "random", False),
       (40, 4, 3, 5, 16, 9, "random", False), (128, 64, 2, 2, 8, 5, "random", False),
       (512, 8, 1, 9, 64, 63, "random", False), (512, 8, 8, 4, 64, 30, "shared", False),
       (512, 8, 8, 4, 64, 30, "distinct", False), (64, 4, 5, 4, 16, 12, "random", False),
       (512, 8, 8, 2, 64, 30, "random", True)]
    # head widths above 128: 160, 256 (bf16 still one 16-byte chunk a lane;
    # float32 on the wide kernel), 320 (the wide kernel in both), past one
    # stage of 64 positions, at position 0, and off a 16-byte boundary
    + [(320, 2, 4, 3, 16, 9, "random", False), (512, 2, 8, 3, 64, 30, "random", False),
       (640, 2, 2, 3, 80, 70, "random", False), (320, 1, 3, 2, 8, 0, "random", False),
       (512, 2, 8, 2, 64, 63, "random", True), (640, 2, 3, 2, 16, 12, "random", True)])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,h,beam,b,lpad,pos,ancestry,misaligned", SELF_ATTENTION_CASES)
def test_self_attention(dev, dtype, d, h, beam, b, lpad, pos, ancestry, misaligned):
    g = torch.Generator().manual_seed(d + pos + lpad)
    bk, n = b * beam, 2
    qkv = rand(g, bk, 3 * d, dtype=dtype)
    if misaligned:
        qkv = _misaligned(qkv)
    k_self, v_self = rand(g, n, lpad, bk, d, dtype=dtype), rand(g, n, lpad, bk, d, dtype=dtype)
    src_t = _ancestry(g, ancestry, lpad, b, beam, dev)
    k1, v1, k2, v2 = k_self.clone(), v_self.clone(), k_self.clone(), v_self.clone()
    before = fd.decoder_self_attention.launches
    got = fd.decoder_self_attention(qkv, k1, v1, 1, pos, src_t, beam, h)
    assert fd.decoder_self_attention.launches == before + 1
    want = fd.decoder_self_attention_reference(qkv, k2, v2, 1, pos, src_t, beam, h)
    assert_close(got, want, dtype)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


# (d, h, beam, b, lenc, misaligned): Lenc 1, 17 and 100 (one tile of
# positions, and several: 32 a tile on the CUDA cores, 64 on the tensor
# cores); head widths 128, 64, 32 and 16 (bf16 on the tensor cores) and 10,
# 8 and 2 (the CUDA cores); beam 1; beam 10 and 20 (two and three row groups
# of an item on the CUDA cores, one and two m16 tiles on the tensor cores);
# inputs off a 16-byte boundary (the CUDA cores)
CROSS_ATTENTION_CASES = [
    (32, 4, 3, 4, 4, False), (256, 2, 2, 3, 16, False), (64, 8, 1, 5, 1, False),
    (512, 8, 8, 3, 1, False), (512, 8, 8, 3, 17, False), (512, 8, 8, 3, 100, False),
    (256, 2, 8, 2, 40, False), (40, 4, 3, 5, 17, False), (128, 64, 2, 2, 5, False),
    (512, 8, 1, 7, 64, False), (64, 2, 10, 3, 33, False), (512, 8, 8, 2, 16, True),
    (64, 2, 20, 2, 70, False), (64, 4, 3, 2, 5, False),
    # head widths above 128 (the wide kernel): 160, 256, 320 and 129, past one
    # stage of 64 positions, two row groups of an item, off a 16-byte boundary
    (320, 2, 3, 2, 17, False), (512, 2, 8, 3, 16, False), (640, 2, 10, 2, 70, False),
    (129, 1, 2, 2, 5, False), (512, 2, 8, 2, 16, True), (640, 2, 3, 2, 64, True)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,h,beam,b,lenc,misaligned", CROSS_ATTENTION_CASES)
def test_cross_attention(dev, dtype, d, h, beam, b, lenc, misaligned):
    g = torch.Generator().manual_seed(d + lenc)
    q = rand(g, b * beam, d, dtype=dtype)
    kv = rand(g, 2, lenc, b, 2 * d, dtype=dtype)
    if misaligned:
        q, kv = _misaligned(q), _misaligned(kv)
    before = fd.decoder_cross_attention.launches
    got = fd.decoder_cross_attention(q, kv, 1, beam, h)
    assert fd.decoder_cross_attention.launches == before + 1
    assert_close(got, fd.decoder_cross_attention_reference(q, kv, 1, beam, h), dtype)


def test_attention_in_cuda_graph(dev):
    """Self-attention at positions 3 and 9 and cross-attention on layers 0
    and 1, captured in one CUDA graph: each replay gives what the same
    launches give eagerly from the same inputs, bit for bit, caches too."""
    g = torch.Generator().manual_seed(11)
    b, beam, d, h, lpad, lenc, bf16 = 4, 8, 512, 8, 16, 16, torch.bfloat16
    bk = b * beam
    qkv_a, qkv_b = rand(g, bk, 3 * d, dtype=bf16), rand(g, bk, 3 * d, dtype=bf16)
    k_self, v_self = rand(g, 2, lpad, bk, d, dtype=bf16), rand(g, 2, lpad, bk, d, dtype=bf16)
    src_t = _ancestry(g, "random", lpad, b, beam, dev)
    q, kv = rand(g, bk, d, dtype=bf16), rand(g, 2, lenc, b, 2 * d, dtype=bf16)

    def run(ks, vs):
        return (fd.decoder_self_attention(qkv_a, ks, vs, 1, 3, src_t, beam, h),
                fd.decoder_self_attention(qkv_b, ks, vs, 1, 9, src_t, beam, h),
                fd.decoder_cross_attention(q, kv, 0, beam, h),
                fd.decoder_cross_attention(q, kv, 1, beam, h))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(k_self.clone(), v_self.clone())
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run(k_self, v_self)
    for seed in range(2):
        g2 = torch.Generator().manual_seed(100 + seed)
        for t in (qkv_a, qkv_b, q):
            t.copy_(rand(g2, *t.shape, dtype=bf16))
        k0, v0 = k_self.clone(), v_self.clone()
        graph.replay()
        torch.cuda.synchronize()
        k_e, v_e = k0.clone(), v0.clone()
        for got, want in zip(outs, run(k_e, v_e)):
            assert torch.equal(got, want)
        assert torch.equal(k_self, k_e) and torch.equal(v_self, v_e)
        k_r, v_r = k0.clone(), v0.clone()
        wants = (fd.decoder_self_attention_reference(qkv_a, k_r, v_r, 1, 3, src_t, beam, h),
                 fd.decoder_self_attention_reference(qkv_b, k_r, v_r, 1, 9, src_t, beam, h),
                 fd.decoder_cross_attention_reference(q, kv, 0, beam, h),
                 fd.decoder_cross_attention_reference(q, kv, 1, beam, h))
        for got, want in zip(outs, wants):
            assert_close(got, want, bf16)


# (V, topk, rows): rows held in registers (V 2000 of the main path, 512
# rows; 40; 300), streamed (V 7, 13000, 10001 not a multiple of 4), lists of
# 8 and 16, and the rounds kernel above 16 (topk 17 and 128)
@pytest.mark.parametrize("v,topk,bk", [(40, 1, 12), (300, 8, 12), (13000, 10, 12), (7, 7, 12),
                                       (2000, 8, 512), (10001, 8, 12), (300, 128, 12),
                                       (2000, 16, 12), (2000, 17, 12)])
def test_logsoftmax_topk(dev, v, topk, bk):
    """Distinct spaced logits (ids must be equal), planted exact ties and
    finished rows (whose other columns all tie at -1e9): lowest id first."""
    g = torch.Generator().manual_seed(v)
    logits = (torch.argsort(torch.rand(bk, v, generator=g), 1).float() / v * 8 - 4).to(dev)
    top = logits.argmax(1)
    logits[:4, -1] = logits[torch.arange(4, device=dev), top[:4]]
    scores = rand(g, bk, 1)
    finished = (torch.arange(bk, device=dev) % 3 == 0).float()[:, None]
    got_s, got_i = fd.decoder_logsoftmax_topk(logits, scores, finished, topk)
    want_s, want_i = fd.decoder_logsoftmax_topk_reference(logits, scores, finished, topk)
    assert_close(got_s, want_s, torch.float32)
    assert torch.equal(got_i, want_i)


@pytest.mark.parametrize("v,topk", [(2000, 8), (2001, 8), (2000, 20)])
def test_logsoftmax_topk_rounding_ties(dev, v, topk):
    """Five near-zero logits, distinct and largest, differ by less than an ulp
    of lse: subtracting lse rounds them to one total, which the plain version
    ranks by id (3, 10, 50, 100, 900), not by logit (100, 50, 900, 10, 3).
    Registers (V 2000), streamed (2001) and rounds (topk 20)."""
    g = torch.Generator().manual_seed(3)
    bk = 6
    logits = -1 - 7 * torch.rand(bk, v, generator=g)
    ids = torch.tensor([100, 50, 900, 10, 3])
    logits[:, ids] = torch.tensor([4e-8, 3e-8, 2e-8, 1e-8, 0.0])
    logits = logits.to(dev)
    scores, finished = torch.zeros(bk, 1, device=dev), torch.zeros(bk, 1, device=dev)
    got_s, got_i = fd.decoder_logsoftmax_topk(logits, scores, finished, topk)
    want_s, want_i = fd.decoder_logsoftmax_topk_reference(logits, scores, finished, topk)
    assert want_i[:, :5].tolist() == [[3, 10, 50, 100, 900]] * bk
    assert_close(got_s, want_s, torch.float32)
    assert torch.equal(got_i, want_i)


def test_wrappers_reject_bad_inputs(dev):
    x = torch.zeros(4, 8, device=dev)
    with pytest.raises(ValueError):
        fd.decoder_linear(x, torch.zeros(9, 8, device=dev), torch.zeros(8, device=dev))
    with pytest.raises(TypeError):
        fd.decoder_linear(x.half(), torch.zeros(8, 8, device=dev).half(),
                          torch.zeros(8, device=dev))
    with pytest.raises(ValueError):
        fd.decoder_linear(x.t(), torch.zeros(4, 8, device=dev), torch.zeros(8, device=dev))
    # bf16 x that starts 2 bytes past a 16-byte boundary: TMA cannot read it
    xb = torch.zeros(33, dtype=torch.bfloat16, device=dev)[1:].view(4, 8)
    wb = torch.zeros(8, 8, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16-byte"):
        fd.decoder_linear(xb, wb, torch.zeros(8, device=dev))
    with pytest.raises(ValueError, match="d % H"):   # 30 % 4, and a head of 129
        fd.decoder_cross_attention(torch.zeros(4, 30, device=dev),
                                   torch.zeros(1, 3, 2, 60, device=dev), 0, 2, 4)
    # a head of 129 (above the fast kernels' 128) is no longer refused: the
    # same call matches the plain version
    q, kv = rand(torch.Generator().manual_seed(129), 4, 129, dev=dev), \
        rand(torch.Generator().manual_seed(258), 1, 3, 2, 258, dev=dev)
    assert_close(fd.decoder_cross_attention(q, kv, 0, 2, 1),
                 fd.decoder_cross_attention_reference(q, kv, 0, 2, 1), torch.float32)
    with pytest.raises(ValueError, match="Lenc = 0"):
        fd.decoder_cross_attention(torch.zeros(4, 8, device=dev),
                                   torch.zeros(1, 0, 2, 16, device=dev), 0, 2, 2)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_decode_step_matches_reference(dev, dtype):
    """The whole step on a small random decoder, 4 steps with a reorder;
    scores within atol 3e-4 (float32, ids equal) / 0.1 (bfloat16, where
    roundings compound over the layers), as chip_smoke.py holds it."""
    from fpn_mt_image_captioning_torch.models.transformer import Transformer
    from fpn_mt_image_captioning_torch.weights import init_weights

    with torch.device("meta"):
        model = Transformer(2, 32, 4, 64, 16, 50, max_seq_len=7,
                            backbone_name="mobilenet224_0.35", activation="gelu")
    model.to_empty(device="cpu")
    init_weights(model, torch.Generator().manual_seed(1))
    model.to(dev)
    packed = fd.pack_decoder_weights(model, dtype)
    b, beam = 3, 2
    bk = b * beam
    g = torch.Generator().manual_seed(2)
    enc = rand(g, b, 4, 32, dtype=dtype)
    ck, cr = fd.init_fused_cache(packed, enc, beam, 7), fd.init_fused_cache(packed, enc, beam, 7)
    own = (torch.arange(bk, device=dev) % beam).to(torch.int32)
    src = own[None].repeat(ck["k_self"].shape[1], 1)
    scores, fin = rand(g, bk, 1), torch.zeros(bk, 1, device=dev)
    kw = dict(num_layers=2, beam=beam, num_heads=4, topk=3, activation="gelu")
    tol = 3e-4 if dtype == torch.float32 else 0.1
    for t in range(4):
        x = rand(g, bk, 32, dtype=dtype)
        ks, ki, ck = fd.fused_decode_step(packed, ck, x, src, t, scores, fin, **kw)
        rs, ri, cr = fd.fused_decode_step_reference(packed, cr, x, src, t, scores, fin, **kw)
        assert float((ks - rs).abs().max()) <= tol
        if dtype == torch.float32:
            assert torch.equal(ki, ri)
        if t == 1:
            src = src[:, (torch.arange(bk, device=dev) // beam) * beam]
        src[t + 1] = own
    assert float((ck["k_self"].float() - cr["k_self"].float()).abs().max()) <= tol


# ---------------------------------------------------------------------------
# the fused MobileNetV2 block (csrc/fused_backbone.cu)
# ---------------------------------------------------------------------------
def _ir_block(g, cin, cexp, cout, expand, dtype, dev):
    blk = {}
    if expand:
        blk["w_exp"] = rand(g, cin, cexp, scale=cin ** -0.5, dtype=dtype, dev=dev)
        blk["b_exp"] = rand(g, cexp, scale=0.5, dev=dev)
    blk["w_dw"] = rand(g, 9, cexp, scale=0.3, dev=dev)
    blk["b_dw"] = rand(g, cexp, scale=0.5, dev=dev)
    blk["w_proj"] = rand(g, cexp, cout, scale=cexp ** -0.5, dtype=dtype, dev=dev)
    blk["b_proj"] = rand(g, cout, scale=0.5, dev=dev)
    return blk


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,hw,cin,cexp,cout,stride,expand,residual", [
    (2, 20, 40, 240, 40, 1, True, True),       # extents not a multiple of the 8-pixel tile
    (3, 6, 24, 144, 400, 2, True, False),      # two 320-channel slices of the output
    (1, 14, 136, 816, 224, 2, True, False),    # alpha-1.4 width: 4-row tiles
    (2, 10, 16, 16, 8, 2, False, False),       # no expand at stride 2
    (1, 2, 8, 48, 8, 1, True, True),           # a 2×2 image inside one tile
    (2, 9, 12, 72, 20, 1, True, False),        # odd extent at stride 1, channels not /8
    (5, 128, 24, 144, 24, 1, True, True),      # enough pixels for 16-row tiles
])
def test_fused_ir_block(dev, dtype, b, hw, cin, cexp, cout, stride, expand, residual):
    from fpn_mt_image_captioning_torch.ops import fused_backbone as fb

    g = torch.Generator().manual_seed(hw * 31 + cin)
    x = rand(g, b, hw, hw, cin, dtype=dtype, dev=dev)
    blk = _ir_block(g, cin, cexp, cout, expand, dtype, dev)
    before = fb.fused_ir_block.launches
    got = fb.fused_ir_block(x, blk, stride=stride, residual=residual)
    assert fb.fused_ir_block.launches == before + 1
    want = fb.fused_ir_block_reference(x, blk, stride=stride, residual=residual)
    assert got.shape == (b, hw // stride, hw // stride, cout) and got.dtype == dtype
    got, want = got.float(), want.float()
    tol = 2e-4 + 1e-3 * want.abs() if dtype == torch.float32 else 1e-2 + 1e-2 * want.abs()
    assert torch.isfinite(got).all() and bool(((got - want).abs() <= tol).all())


# every distinct block shape of a 512² mobilenet224_1.0 encode: (input
# extent, Cin, Cexp, Cout, stride, expand, residual)
FLAGSHIP_BLOCKS = [
    (256, 32, 32, 16, 1, False, False), (256, 16, 96, 24, 2, True, False),
    (128, 24, 144, 24, 1, True, True), (128, 24, 144, 32, 2, True, False),
    (64, 32, 192, 32, 1, True, True), (64, 32, 192, 64, 2, True, False),
    (32, 64, 384, 64, 1, True, True), (32, 64, 384, 96, 1, True, False),
    (32, 96, 576, 96, 1, True, True), (32, 96, 576, 160, 2, True, False),
    (16, 160, 960, 160, 1, True, True), (16, 160, 960, 320, 1, True, False)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("hw,cin,cexp,cout,stride,expand,residual", FLAGSHIP_BLOCKS)
def test_fused_ir_block_flagship_shapes(dev, dtype, hw, cin, cexp, cout, stride, expand,
                                        residual):
    test_fused_ir_block(dev, dtype, 2, hw, cin, cexp, cout, stride, expand, residual)


@pytest.mark.parametrize("hw,cin,cexp,cout,stride,expand,residual", FLAGSHIP_BLOCKS)
def test_fused_ir_block_occupancy(dev, hw, cin, cexp, cout, stride, expand, residual):
    """The bfloat16 kernel keeps at least two blocks an SM at every flagship
    shape, registers and shared memory together, as the card counts them."""
    from fpn_mt_image_captioning_torch.ops import fused_backbone as fb

    pixels = 64 * (hw // stride) ** 2   # a batch-64 encode's plan
    assert fb.block_occupancy(cin, cout, stride, torch.bfloat16, expand, pixels) >= 2


def test_fused_ir_block_rejects_bad_inputs(dev):
    from fpn_mt_image_captioning_torch.ops import fused_backbone as fb

    g = torch.Generator().manual_seed(0)
    blk = _ir_block(g, 16, 96, 24, True, torch.float32, dev)
    with pytest.raises(ValueError, match="even extents"):
        fb.fused_ir_block(rand(g, 1, 7, 8, 16, dev=dev), blk, stride=2, residual=False)
    with pytest.raises(ValueError, match="w_exp"):
        fb.fused_ir_block(rand(g, 1, 8, 8, 16, dtype=torch.bfloat16, dev=dev), blk, stride=1,
                          residual=False)
    with pytest.raises(ValueError, match="residual"):
        fb.fused_ir_block(rand(g, 1, 8, 8, 16, dev=dev), blk, stride=1, residual=True)


# ---------------------------------------------------------------------------
# the measurement probes: x + 1 and the slab copies (csrc/probes.cu), and the
# decode step on fused_decoder.cu built with empty kernel bodies, each exactly
# equal to its plain version
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", ["add_one", "add_one_grid7"])
@pytest.mark.parametrize("shape", [(1,), (1000,), (256, 256), (3, 517)])
def test_probe_add_one(dev, kernel, shape):
    from fpn_mt_image_captioning_torch.ops import probes as pr

    fn = getattr(pr, kernel)
    x = rand(torch.Generator().manual_seed(len(shape)), *shape, dev=dev)
    before = fn.launches
    got = fn(x)
    assert fn.launches == before + 1
    assert torch.equal(got, pr.add_one_reference(x))


def _probe_step_setup(dev, b_items, beam, with_oh=True, dots=0, num_layers=2):
    from fpn_mt_image_captioning_torch.ops import probes as pr

    s = pr.step_setup(b_items=b_items, beam=beam, d=64, num_heads=4, dff=128, vocab=300,
                      num_layers=num_layers, lpad=8, lenc=4, with_oh=with_oh, tile=16,
                      compute_dots=dots, device=dev)
    s["scores"].copy_(rand(torch.Generator().manual_seed(b_items * beam), b_items * beam, 1,
                           dev=dev))
    return pr, s


def _step_counts(pr):
    return [k.launches for k in pr.TRIVIAL_DECODER.KERNELS]


@pytest.mark.parametrize("b_items,beam,with_oh,dots", [(1, 8, True, 0), (3, 2, False, 2),
                                                       (5, 3, True, 1)])
def test_probe_step(dev, b_items, beam, with_oh, dots):
    """The decode step on the trivial build (B = 1 among the cases): each
    kind launched as often as in the real step, the real linears on top,
    the top-k scores equal to the contract."""
    pr, s = _probe_step_setup(dev, b_items, beam, with_oh, dots)
    before, lin = _step_counts(pr), fd.decoder_linear.launches
    tops = pr.probe_step(s)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_step_counts(pr), before)] == [13, 6, 2, 2, 1]
    assert fd.decoder_linear.launches - lin == 2 * dots
    assert torch.equal(tops, pr.probe_step_reference(s["scores"], beam))


def test_probe_step_cuda_graph(dev):
    """One step captured in a CUDA graph: the counters count the capture
    once and no replay; every replay rewrites tops from the current scores."""
    from fpn_mt_image_captioning_torch.scripts import probe_launch_overhead as plo

    pr, s = _probe_step_setup(dev, 2, 4)
    before = _step_counts(pr)
    graph, tops = plo.capture_step(s)
    after_capture = _step_counts(pr)
    # the capture's own launches: once for the warm-up step, once for the capture
    assert [a - b for a, b in zip(after_capture, before)] == [26, 12, 4, 4, 2]
    for seed in range(3):
        s["scores"].copy_(rand(torch.Generator().manual_seed(seed), 8, 1, dev=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(tops, pr.probe_step_reference(s["scores"], 4))
    assert _step_counts(pr) == after_capture


# (B, Hp, Wp, C, rows, n_tiles): a slab the chunks do not divide with Wp > 256
# (two boxes a row), B = 1, narrow channels, and a flat slab of several boxes
SLAB_CASES = [(1, 23, 300, 32, 7, 3), (2, 10, 16, 8, 4, 2), (3, 66, 40, 32, 16, 4),
              (2, 258, 272, 32, 64, 1)]
SLAB_WRAPPERS = [("slab_copy_4d", "A"), ("slab_copy_3d", "B"), ("slab_copy_lane128", "C"),
                 ("slab_copy_flat", "D"), ("slab_copy_flat_loads", "D"),
                 ("slab_copy_flat_cp_async", "D")]


@pytest.mark.parametrize("wrapper,layout", SLAB_WRAPPERS)
@pytest.mark.parametrize("b,hp,wp,c,rows,n_tiles", SLAB_CASES)
def test_probe_slab_copy(dev, wrapper, layout, b, hp, wp, c, rows, n_tiles):
    from fpn_mt_image_captioning_torch.ops import probes as pr

    fn = getattr(pr, wrapper)
    x = rand(torch.Generator().manual_seed(hp + wp), b, hp, wp, c, dtype=torch.bfloat16, dev=dev)
    before = fn.launches
    got = fn(x, rows, n_tiles)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = pr.slab_copy_reference(x, layout, rows, n_tiles)
    assert got.shape == want.shape
    assert torch.equal(pr.slab_rows(got, x.shape, rows, n_tiles),
                       pr.slab_rows(want, x.shape, rows, n_tiles))


def test_probe_slab_copy_bad_tensor_map_raises(dev):
    """4 bf16 channels: an 8-byte row stride, which a TMA tensor map refuses
    (strides are multiples of 16 bytes); the encode's error raises and
    nothing launches."""
    from fpn_mt_image_captioning_torch.ops import probes as pr

    x = torch.zeros(1, 10, 16, 4, dtype=torch.bfloat16, device=dev)
    before = pr.slab_copy_4d.launches
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled"):
        pr.slab_copy_4d(x, 4, 2)
    assert pr.slab_copy_4d.launches == before
    with pytest.raises(ValueError, match="16 bytes"):
        pr.slab_copy_flat_loads(torch.zeros(1, 10, 3, 4, dtype=torch.bfloat16, device=dev), 4, 2)


def test_evaluate_on_the_card(dev, tmp_path):
    """``Pipeline.evaluate`` on the card over a tiny synthetic split (five
    images in batches of two, the tail padded): every decode kernel launches
    its count a step, and the result list equals the CPU route's (the plain
    versions) on the same weights."""
    from fixtures import make_synthetic_dataset
    from fpn_mt_image_captioning_torch.config import Config
    from fpn_mt_image_captioning_torch.data.dataset import COCO_Images_ImageID
    from fpn_mt_image_captioning_torch.data.tokenizer import REFERENCE_FILTERS, Tokenizer
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

    datadir = make_synthetic_dataset(str(tmp_path), n_train=1, n_val=5, image_size=256)
    tok = Tokenizer(num_words=100, oov_token="unk", filters=REFERENCE_FILTERS)
    tok.fit_on_texts(["<start> " + " ".join(f"w{i}" for i in range(j, j + 5)) + " <end>"
                      for j in range(20)])
    tok.add_padding_token()
    cfg = Config(image_input_size=256, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
                 num_heads=4, dff=64, beam_search_n=3, compute_dtype="float32", decode_batch=2,
                 datadir=datadir)
    cpu = Pipeline(tok, 8, cfg, seed=3, device="cpu")
    card = Pipeline(tok, 8, cfg, seed=3, device=dev)   # the same seeded init

    def split():
        return COCO_Images_ImageID(datadir, cfg.datatype_val, 5, image_size=256, seed=0)

    fd.reset_launch_counts()
    got = card.evaluate(split())
    steps = fd.decoder_logsoftmax_topk.launches
    nl = cfg.num_layers
    assert steps > 0 and [k.launches for k in fd.KERNELS] == [
        steps * n for n in (6 * nl + 1, 3 * nl, nl, nl, 1)]
    assert got == cpu.evaluate(split()) and len(got) == 5


def test_sampling_same_seed_on_the_card(dev):
    """``Pipeline.sample_batch`` on the card: the same seed twice gives the
    same captions (the noise comes from a generator on the card), other
    seeds other captions at temperature 3; the non-fused step launches none
    of the fused decode kernels, and temperature 0 gives the card's greedy
    decode (float32: bf16 logits tie exactly often enough that the noise,
    not the lowest index, would pick among them)."""
    import numpy as np

    from fpn_mt_image_captioning_torch.config import Config
    from fpn_mt_image_captioning_torch.data.tokenizer import REFERENCE_FILTERS, Tokenizer
    from fpn_mt_image_captioning_torch.decode.beam_search import greedy_decode
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

    tok = Tokenizer(num_words=100, oov_token="unk", filters=REFERENCE_FILTERS)
    tok.fit_on_texts(["<start> " + " ".join(f"w{i}" for i in range(j, j + 5)) + " <end>"
                      for j in range(20)])
    tok.add_padding_token()
    cfg = Config(image_input_size=256, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
                 num_heads=4, dff=64, compute_dtype="float32")
    pipe = Pipeline(tok, 8, cfg, seed=3, device=dev)
    images = np.random.default_rng(0).integers(0, 256, (16, 256, 256, 3), dtype=np.uint8)
    fd.reset_launch_counts()
    a = pipe.sample_batch(images, seed=7, temperature=3.0, top_k=5, top_p=0.9)
    b = pipe.sample_batch(images, seed=7, temperature=3.0, top_k=5, top_p=0.9)
    assert all((x == y).all() for x, y in zip(a, b))
    others = {pipe.sample_batch(images, seed=s, temperature=3.0)[0].tobytes() for s in range(3)}
    assert len(others) > 1
    assert [k.launches for k in fd.KERNELS] == [0] * len(fd.KERNELS)
    zero = pipe.sample_batch(images, seed=1, temperature=0.0)
    greedy = greedy_decode(pipe.transformer, pipe.encode(images), max_len=8,
                           start_token=pipe.start_token, end_token=pipe.end_token)
    assert (zero[0] == greedy[0].cpu().numpy()).all()
