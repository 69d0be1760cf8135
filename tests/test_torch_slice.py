"""The port's captioning slice end to end against the JAX package:
``Pipeline.predict_batch`` (encode + fused beam search + detokenize, plain
kernels on the CPU) vs JAX ``encode`` + ``beam_search(fused=False)``, with the
same perturbed weights; plus the port's device rule and its independence
from JAX."""

import ast
import os
import pathlib
import subprocess
import sys
from collections.abc import Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_tpu.data.tokenizer import REFERENCE_FILTERS
from fpn_mt_image_captioning_tpu.data.tokenizer import Tokenizer as JxTokenizer
from fpn_mt_image_captioning_tpu.decode.beam_search import beam_search as jx_beam_search
from fpn_mt_image_captioning_tpu.models.positional import create_masks
from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
from fpn_mt_image_captioning_torch.config import Config
from fpn_mt_image_captioning_torch.data.tokenizer import Tokenizer
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "fpn_mt_image_captioning_torch"
MAX_LEN, BEAM, SIZE = 8, 3, 256
CFG = Config(image_input_size=SIZE, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
             num_heads=4, dff=64, beam_search_n=BEAM, compute_dtype="float32")
# Random weights leave the captions constant: the head trunks' normal(0.01)
# kernels drown the image under the biases' noise and the U(±0.05) embedding
# drowns the tokens under the PE. Scaled up, the captions differ by image and
# some end early; the final layer scaled makes logits peaked (no near ties).
TRUNK_SCALE, EMBED_SCALE, LOGIT_SCALE = 10.0, 20.0, 8.0


def corpus(seed=0, n=60):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(25)]
    return ["<start> " + " ".join(rng.choice(words, rng.integers(2, 7))) + " <end>"
            for _ in range(n)]


def fit(cls):
    tok = cls(num_words=CFG.top_k, oov_token="unk", filters=REFERENCE_FILTERS)
    tok.fit_on_texts(corpus())
    tok.add_padding_token()
    return tok


def perturb(tree, rng):
    """Seeded noise on every leaf; zero/one-initialized leaves get 0.01."""
    if isinstance(tree, Mapping):
        return {k: perturb(v, rng) for k, v in tree.items()}
    a = np.asarray(tree, np.float32)
    return a + 0.1 * (a.std() or 0.1) * rng.standard_normal(a.shape).astype(np.float32)


def slice_variables():
    """The JAX model, its tokenizer, the perturbed variables both packages
    load, and three seeded uint8 images (also used by the serving tests)."""
    jtok = fit(JxTokenizer)
    vocab = len(jtok.index_word)
    jx = JxTransformer(
        num_layers=CFG.num_layers, d_model=CFG.d_model, num_heads=CFG.num_heads, dff=CFG.dff,
        input_vocab_size=CFG.input_vocab_size, target_vocab_size=vocab, max_seq_len=MAX_LEN,
        backbone_name=CFG.backbone)
    key = jax.random.PRNGKey(5)
    tar = jnp.ones((1, MAX_LEN - 1), jnp.int32)
    v = jax.device_get(jax.jit(lambda i, t: jx.init(
        {"params": key, "dropout": key}, i, t, True, create_masks(t)))(
        jnp.zeros((1, SIZE, SIZE, 3)), tar))
    rng = np.random.default_rng(6)
    params = perturb(v["params"], rng)
    fe = params["encoder"]["feature_extractor"]
    for trunk in ("regression_trunk", "classification_trunk"):
        for conv in fe[trunk].values():
            conv["kernel"] = conv["kernel"] * TRUNK_SCALE
    emb = params["decoder"]["embedding"]
    emb["embedding"] = emb["embedding"] * EMBED_SCALE
    params["final_layer"]["kernel"] = params["final_layer"]["kernel"] * LOGIT_SCALE
    stats = jax.tree.map(lambda a: np.asarray(a, np.float32), v["batch_stats"])
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if p[-1].key == "var" else a + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
        stats)
    variables = {"params": params, "batch_stats": stats}
    images = np.random.default_rng(7).integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
    return jx, jtok, variables, images


@pytest.fixture(scope="module")
def setup():
    return slice_variables()


def jax_beam_margins(jx, variables, enc, start, end):
    """Per step, the gap between the beam-th and (beam+1)-th candidate of
    JAX's non-fused search (its log-softmax, freeze and score add, run step by
    step): where it is wide, no rounding can flip a choice."""
    b, bk = enc.shape[0], enc.shape[0] * BEAM
    cache = jx.apply(variables, jnp.repeat(enc, BEAM, axis=0), MAX_LEN + 1,
                     method=JxTransformer.init_cache)
    step = jax.jit(lambda v, tok, t, c, s: jx.apply(v, tok, t, c, s,
                                                     method=JxTransformer.decode_step))
    src = np.broadcast_to(np.arange(bk)[:, None], (bk, MAX_LEN + 1)).copy()
    scores = np.full((b, BEAM), -1e9, np.float32)
    scores[:, 0] = 0.0
    finished = np.zeros((b, BEAM), bool)
    tokens = np.full(bk, start, np.int32)
    margins = []
    for t in range(MAX_LEN):
        if finished.all():
            break
        logits, cache = step(variables, jnp.asarray(tokens), jnp.int32(t), cache,
                             jnp.asarray(src, jnp.int32))
        lp = np.asarray(jax.nn.log_softmax(logits, axis=-1))
        vocab = lp.shape[-1]
        lp = lp.reshape(b, BEAM, vocab)
        pad_row = np.full(vocab, -1e9, np.float32)
        pad_row[0] = 0.0
        lp = np.where(finished[..., None], pad_row, lp)
        total = (scores[..., None] + lp).reshape(b, -1)
        order = np.argsort(-total, axis=1, kind="stable")
        srt = np.take_along_axis(total, order, 1)
        margins.append(srt[:, BEAM - 1] - srt[:, BEAM])
        beam_idx, new_tok = order[:, :BEAM] // vocab, order[:, :BEAM] % vocab
        src = src[(np.arange(b)[:, None] * BEAM + beam_idx).reshape(-1)]
        src[:, t + 1] = np.arange(bk)
        finished = np.take_along_axis(finished, beam_idx, 1) | (new_tok == end)
        scores, tokens = srt[:, :BEAM], new_tok.reshape(-1).astype(np.int32)
    return np.min(margins)


def test_predict_batch_matches_jax(setup):
    jx, jtok, variables, images = setup
    start, end = jtok.word_index["<start>"], jtok.word_index["<end>"]
    enc = jax.jit(lambda v, x: jx.apply(v, x, train=False, method=JxTransformer.encode))(
        variables, images)
    assert jax_beam_margins(jx, variables, enc, start, end) > 1e-3
    j_seqs, j_len, _ = jx_beam_search(jx, variables, enc, beam_n=BEAM, max_len=MAX_LEN,
                                      start_token=start, end_token=end, fused=False)
    j_seqs, j_len = np.asarray(j_seqs), np.asarray(j_len)

    pipe = Pipeline(fit(Tokenizer), MAX_LEN, CFG, variables, device="cpu")
    seqs, lengths = pipe.predict_batch(images)
    np.testing.assert_array_equal(seqs, j_seqs)
    np.testing.assert_array_equal(lengths, j_len)
    captions = [pipe.to_caption(seqs[i], lengths[i]) for i in range(len(images))]
    assert captions == jtok.sequences_to_texts(
        [list(map(int, j_seqs[i, : j_len[i]])) for i in range(len(images))])
    assert all(isinstance(c, str) for c in captions)
    # the comparison is not vacuous: captions differ by image, some end early
    assert len(set(captions)) == len(images) and lengths.min() < MAX_LEN
    np.testing.assert_array_equal(pipe.predict(images[1]), j_seqs[1, : j_len[1]])


def test_max_decode_rows_chunking_is_result_invariant(setup):
    _, _, variables, images = setup
    tok = fit(Tokenizer)
    whole = Pipeline(tok, MAX_LEN, CFG.replace(max_decode_rows=0), variables, device="cpu")
    chunked = Pipeline(tok, MAX_LEN, CFG.replace(max_decode_rows=2 * BEAM), variables,
                       device="cpu")
    a, b = whole.predict_batch(images), chunked.predict_batch(images)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_bfloat16_pipeline_runs_on_cpu(setup):
    _, _, variables, images = setup
    pipe = Pipeline(fit(Tokenizer), MAX_LEN, CFG.replace(compute_dtype="bfloat16"),
                    variables, device="cpu")
    assert pipe.packed["wqkv"].dtype == torch.bfloat16
    assert pipe.packed["ln"].dtype == torch.float32
    seqs, lengths = pipe.predict_batch(images[:2])
    assert seqs.shape == (2, MAX_LEN) and seqs.dtype == np.int32
    assert np.all((lengths >= 0) & (lengths <= MAX_LEN))


def test_pipeline_without_cuda_raises(monkeypatch):
    """No device given and no card: the pipeline refuses instead of running
    on the CPU behind the caller's back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Pipeline(fit(Tokenizer), MAX_LEN, CFG)


def test_load_max_seq_len_matches_jax(tmp_path):
    import json

    from fpn_mt_image_captioning_tpu.data import dataset as jx_dataset
    from fpn_mt_image_captioning_torch.data import dataset as pt_dataset

    path = tmp_path / "info.json"
    path.write_text(json.dumps({"max_seq_len": 23, "best_epoch": 4}))
    assert pt_dataset.load_max_seq_len(str(path)) == jx_dataset.load_max_seq_len(str(path)) == 23
    with pytest.raises(FileNotFoundError, match="max_seq_len"):
        pt_dataset.load_max_seq_len(str(tmp_path / "missing.json"))
    path.write_text("{not json")
    with pytest.raises(ValueError, match="corrupt"):
        pt_dataset.load_max_seq_len(str(path))


def test_kernel_wrapper_refuses_other_devices():
    from fpn_mt_image_captioning_torch.ops.fused_decoder import decoder_linear

    x = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        decoder_linear(x, torch.zeros(3, 4, device="meta"), torch.zeros(4, device="meta"))


FORBIDDEN = ("jax", "jaxlib", "flax", "fpn_mt_image_captioning_tpu", "msgpack", "h5py", "orbax",
             "tensorstore", "zstandard")


def test_port_imports_no_jax():
    """Importing every module of the port (the CLI, the server, the fused
    backbone, the image loader, the weight files, the metrics and the
    evaluation entry points among them) and ``chip_smoke``, in a fresh
    interpreter, loads neither JAX, Flax, the JAX package, msgpack, h5py,
    Orbax, tensorstore nor zstandard; no source names them either. Nor does it load
    matplotlib, which the card's machine lacks: the plotting functions
    import it when they run."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fpn_mt_image_captioning_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names + ['chip_smoke']:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "assert 'matplotlib' not in sys.modules\n"
        "print(' '.join(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    imported = set(out.stdout.split())
    for name in ("caption", "serve", "ops.fused_backbone", "ops.fused_decoder",
                 "runtime.native_loader", "data.dataset", "utils.profiling", "weights",
                 "test", "evaluate", "show_results", "data.coco", "data.metrics",
                 "data.metrics.ptb", "data.metrics.bleu", "data.metrics.rouge",
                 "data.metrics.meteor", "data.metrics.cider", "utils.porter",
                 "utils.figures", "decode.beam_search", "models.positional"):
        assert f"fpn_mt_image_captioning_torch.{name}" in imported, name

    for path in [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]:
        if path.is_relative_to(PORT) and path.relative_to(PORT).parts[0] == "build":
            continue   # kernel build outputs
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, \
                    f"{path.relative_to(REPO)} imports {name}"
