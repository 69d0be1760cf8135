"""The fused decode step's CUDA kernels against their plain PyTorch versions
on the card, at small and ragged shapes that the flagship smoke run does not
reach (odd M/N/K, head width 8 and 128, position 0, a vocabulary whose totals
exceed 48 KB of shared memory, exact ties). Needs a CUDA card and nvcc: every
test here skips on a machine without one. On the card (which has no JAX, so
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(5, 24, 40), (64, 512, 136), (130, 100, 36), (1, 8, 8)])
@pytest.mark.parametrize("act,out_f32", [("none", True), ("leaky_relu", False), ("gelu", False),
                                         ("relu6", True), ("relu", False)])
def test_linear(dev, dtype, m, k, n, act, out_f32):
    g = torch.Generator().manual_seed(m * 7 + n)
    x, w = rand(g, m, k, dtype=dtype), rand(g, k, n, scale=k ** -0.5, dtype=dtype)
    b = rand(g, n, scale=0.5)
    before = fd.decoder_linear.launches
    got = fd.decoder_linear(x, w, b, act, out_f32)
    assert fd.decoder_linear.launches == before + 1
    assert got.dtype == (torch.float32 if out_f32 else dtype)
    assert_close(got, fd.decoder_linear_reference(x, w, b, act, out_f32), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(3, 32), (17, 512), (2, 1000)])
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,h,beam,b", [(32, 4, 3, 4), (256, 2, 2, 3), (64, 8, 1, 5)])
@pytest.mark.parametrize("pos", [0, 1, 7])
def test_self_attention(dev, dtype, d, h, beam, b, pos):
    g = torch.Generator().manual_seed(d + pos)
    bk, lpad, n = b * beam, 8, 2
    qkv = rand(g, bk, 3 * d, dtype=dtype)
    k_self, v_self = rand(g, n, lpad, bk, d, dtype=dtype), rand(g, n, lpad, bk, d, dtype=dtype)
    src_t = torch.randint(0, beam, (lpad, bk), generator=g, dtype=torch.int32).to(dev)
    k1, v1, k2, v2 = k_self.clone(), v_self.clone(), k_self.clone(), v_self.clone()
    got = fd.decoder_self_attention(qkv, k1, v1, 1, pos, src_t, beam, h)
    want = fd.decoder_self_attention_reference(qkv, k2, v2, 1, pos, src_t, beam, h)
    assert_close(got, want, dtype)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,h,beam,b,lenc", [(32, 4, 3, 4, 4), (256, 2, 2, 3, 16), (64, 8, 1, 5, 1)])
def test_cross_attention(dev, dtype, d, h, beam, b, lenc):
    g = torch.Generator().manual_seed(d + lenc)
    q = rand(g, b * beam, d, dtype=dtype)
    kv = rand(g, 2, lenc, b, 2 * d, dtype=dtype)
    assert_close(fd.decoder_cross_attention(q, kv, 1, beam, h),
                 fd.decoder_cross_attention_reference(q, kv, 1, beam, h), dtype)


@pytest.mark.parametrize("v,topk", [(40, 1), (300, 8), (13000, 10), (7, 7)])
def test_logsoftmax_topk(dev, v, topk):
    """Distinct spaced logits (ids must be equal), planted exact ties and
    finished rows (whose other columns all tie at -1e9): lowest id first."""
    g = torch.Generator().manual_seed(v)
    bk = 12
    logits = (torch.argsort(torch.rand(bk, v, generator=g), 1).float() / v * 8 - 4).to(dev)
    top = logits.argmax(1)
    logits[:4, -1] = logits[torch.arange(4, device=dev), top[:4]]
    scores = rand(g, bk, 1)
    finished = (torch.arange(bk, device=dev) % 3 == 0).float()[:, None]
    got_s, got_i = fd.decoder_logsoftmax_topk(logits, scores, finished, topk)
    want_s, want_i = fd.decoder_logsoftmax_topk_reference(logits, scores, finished, topk)
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
