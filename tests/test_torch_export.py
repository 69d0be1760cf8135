"""The port's serving artifact (``fpn_mt_image_captioning_torch/export.py``)
on the CPU, beside the JAX package's (``tests/test_export.py``): the layout
and metadata, round trips bitwise equal to the port's ``Pipeline`` (beam
search on float and uint8 images, both sampling programs, chunked and
padded requests), the CLI and the server on ``--artifact``, the export-time
guards, ``fold_chunk_seed`` equal to the JAX function; and what is the
port's own: the artifact's captions equal the JAX package's
``Pipeline.predict_batch`` on the same weights, its float32 weight file
restores under flax to the JAX variables, the beam graph holds each decode
kernel's custom operator ``max_len`` × its launches a step and no
cache-sized copy, the fixed trip count equals the early stop, a fresh
process serves without the model module, and a device mismatch raises.

A small float32 model (256², mobilenet224_0.35, d 32, 2+2 layers, beam 2,
max_seq_len 8: the weights of ``tests/test_torch_slice.py``, whose captions
differ by image and some end early) exported once, at batch 2, for the
module; torch on one intra-op thread."""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from fpn_mt_image_captioning_torch import caption as pt_caption
from fpn_mt_image_captioning_torch import export as ex
from fpn_mt_image_captioning_torch import serve as pt_serve
from fpn_mt_image_captioning_torch.decode.beam_search import beam_search, sample_decode
from fpn_mt_image_captioning_torch.decode.noise import gumbel
from fpn_mt_image_captioning_torch.ops import fused_decoder as fd
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from test_torch_slice import MAX_LEN, SIZE
from test_torch_weight_files import jax_world

BEAM, BATCH = 2, 2
PER_STEP = {"fpn_mt::decoder_linear": 6 * 2 + 1, "fpn_mt::decoder_add_layernorm": 3 * 2,
            "fpn_mt::decoder_self_attention": 2, "fpn_mt::decoder_cross_attention": 2,
            "fpn_mt::decoder_logsoftmax_topk": 1}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (see
    tests/test_torch_backbones.py): faster at these shapes, and the suite's
    worker processes do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def exported(tmp_path_factory, one_torch_thread):
    """The JAX world of the weight-file tests (its ``Pipeline``, the msgpack
    file, the tokenizer and a synthetic split), the port's float32 pipeline
    on those weights at beam 2, its artifact with sampling at batch 2, and
    the artifact loaded on the CPU."""
    world = jax_world(tmp_path_factory.mktemp("export"))
    cfg = world["cfg"].replace(beam_search_n=BEAM, decode_batch=BATCH)
    pipe = Pipeline.from_config(cfg, device="cpu")
    out = str(world["root"] / "artifact")
    meta = ex.export_serving(pipe, out, batch=BATCH, sample=True)
    served = ex.load_serving(out, "cpu")
    return dict(world, cfg=cfg, pipe=pipe, meta=meta, out=out, served=served)


def images_of(seed, n, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)
    return rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


def assert_equal(got, want):
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])


def test_artifact_layout_and_meta(exported):
    pipe, served, meta, out = exported["pipe"], exported["served"], exported["meta"], \
        exported["out"]
    for fname in ("serving.pt2", "sampling.pt2", "sampling_nucleus.pt2", "serving_u8.pt2",
                  "sampling_u8.pt2", "sampling_nucleus_u8.pt2", "weights.msgpack",
                  "tokenizer.json", "artifact.json"):
        assert os.path.exists(os.path.join(out, fname))
    assert meta["accepts_uint8"] is True and served.accepts_uint8
    assert meta["batch"] == BATCH and meta["beam_n"] == BEAM
    assert meta["image_size"] == SIZE and meta["max_seq_len"] == pipe.max_seq_len
    assert meta["fused_decoder"] is True and meta["fused_backbone"] is False
    assert meta["platforms"] == ["cpu"] and meta["torch_version"] == torch.__version__
    assert meta["sampling"] is True and served.supports_sampling
    with open(os.path.join(out, "artifact.json")) as f:
        assert json.load(f) == meta
    # no program carries the weights: the weight file holds them once
    weights = os.path.getsize(os.path.join(out, "weights.msgpack"))
    for prog in meta["programs"].values():
        assert prog["state_bytes"] == 0 and prog["constant_bytes"] < weights / 100


def test_roundtrip_equals_pipeline(exported):
    """Three images through the batch-2 program (chunk, pad, trim) equal the
    live pipeline bitwise, and so do the captions."""
    pipe, served = exported["pipe"], exported["served"]
    imgs = images_of(0, 3, np.float32)
    want, got = pipe.predict_batch(imgs), served.predict_batch(imgs)
    assert_equal(got, want)
    assert served.caption(imgs) == [pipe.to_caption(s, n) for s, n in zip(*want)]


def test_uint8_feed_roundtrip(exported):
    """uint8 images through the uint8 programs equal the host-normalized
    float images through the float programs (the CPU divides exactly), and
    the live pipeline's uint8 feed; both sampling twins too."""
    pipe, served = exported["pipe"], exported["served"]
    u8 = images_of(7, 3)
    as_float = u8.astype(np.float32) / 127.5 - 1.0
    got = served.predict_batch(u8)
    assert_equal(served.predict_batch(as_float), got)
    assert_equal(got, pipe.predict_batch(u8))
    for top_p in (None, 0.9):
        assert_equal(served.sample_batch(u8, seed=3, temperature=0.8, top_p=top_p),
                     served.sample_batch(as_float, seed=3, temperature=0.8, top_p=top_p))


def test_sampling_roundtrip(exported):
    """Both sampling programs equal the exported function run eagerly chunk
    by chunk, on the noise drawn from ``fold_chunk_seed(seed, chunk)``; a
    full chunk equals ``Pipeline.sample_batch`` with the same seed; a
    near-zero temperature gives the greedy (beam-1) caption; ``top_k``
    raises."""
    pipe, served, meta = exported["pipe"], exported["served"], exported["meta"]
    imgs = images_of(1, 3, np.float32)
    temps = np.asarray([0.7, 1.0, 1.3], np.float32)
    tps = np.asarray([0.9, 1.0, 0.8], np.float32)
    weights = ex._served_weights(pipe)
    pad = lambda a, v: np.concatenate([a, np.full((1, *a.shape[1:]), v, a.dtype)])
    for nucleus in (False, True):
        fn = ex.build_sampling_fn(pipe.transformer, max_len=MAX_LEN,
                                  start_token=meta["start_token"],
                                  end_token=meta["end_token"], nucleus=nucleus)
        imgs_p, t_p, tp_p = pad(imgs, 0.0), pad(temps, 1.0), pad(tps, 1.0)
        want = []
        for c, i in enumerate(range(0, 4, BATCH)):
            gen = torch.Generator().manual_seed(ex.fold_chunk_seed(5, c))
            noise = torch.stack([gumbel(gen, (BATCH, meta["target_vocab_size"]), "cpu")
                                 for _ in range(MAX_LEN)])
            rows = [torch.as_tensor(t_p[i:i + BATCH])] + (
                [torch.as_tensor(tp_p[i:i + BATCH])] if nucleus else [])
            with torch.no_grad():
                want.append(fn(weights, torch.as_tensor(imgs_p[i:i + BATCH]), noise, *rows))
        want = (np.concatenate([s.numpy() for s, _ in want])[:3],
                np.concatenate([n.numpy() for _, n in want])[:3])
        top_p = tps if nucleus else None
        assert_equal(served.sample_batch(imgs, seed=5, temperature=temps, top_p=top_p), want)
        assert_equal(served.sample_batch(imgs[:2], seed=5, temperature=temps[:2],
                                         top_p=None if top_p is None else top_p[:2]),
                     pipe.sample_batch(imgs[:2], seed=5, temperature=temps[:2],
                                       top_p=None if top_p is None else top_p[:2]))
    s_g, l_g = served.sample_batch(imgs[:1], temperature=1e-7)
    s_b, l_b = pipe.predict_batch(imgs[:1], beam_n=1)
    assert served.to_caption(s_g[0], l_g[0]) == pipe.to_caption(s_b[0], l_b[0])
    with pytest.raises(ValueError, match="top_k"):
        served.sample_batch(imgs, top_k=5)


def png_bytes(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def start(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return f"http://127.0.0.1:{srv.server_address[1]}", thread


def post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def test_sampling_artifact_over_http(exported):
    """The server in ``decode="sample"`` on the artifact: per-request
    sampling parameters ride the exported programs; a temperature-0 request
    gives the greedy caption of its padded batch."""
    served, meta = exported["served"], exported["meta"]
    cfg = served.apply_to_config(exported["cfg"])
    srv = pt_serve.make_server(cfg, port=0, serve_batch=meta["batch"], max_delay_ms=20.0,
                               pipeline=served, decode="sample", sample_seed=11)
    base, thread = start(srv)
    img = images_of(3, 1)[0]
    try:
        status, body = post(base + "/caption?temperature=0.8&top_p=0.95", png_bytes(img))
        assert status == 200 and isinstance(body["caption"], str)
        status, body = post(base + "/caption?temperature=0", png_bytes(img))
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        thread.join(timeout=60)
    s, n = served.sample_batch(np.stack([img, np.zeros_like(img)]), temperature=[0.0, 1.0])
    assert status == 200 and body["caption"] == served.to_caption(s[0], n[0])


@pytest.fixture(scope="module")
def beam_only(exported):
    """``python -m fpn_mt_image_captioning_torch.export --verify`` without
    ``--sample``, at batch 1, on the Config's weight file: the metadata, the
    artifact's directory and what it printed."""
    cfg, out = exported["cfg"], str(exported["root"] / "beam_only")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        meta = ex.main([f"--out_dir={out}", "--batch=1", "--verify", "--device=cpu",
                        f"--tokenizer_filename={cfg.tokenizer_filename}",
                        f"--additional_filename={cfg.additional_filename}",
                        f"--transformer_weight_path={cfg.transformer_weight_path}",
                        f"--image_input_size={SIZE}", f"--backbone={cfg.backbone}",
                        f"--d_model={cfg.d_model}", f"--num_layers={cfg.num_layers}",
                        f"--num_heads={cfg.num_heads}", f"--dff={cfg.dff}",
                        f"--beam_search_n={BEAM}", "--compute_dtype=float32"])
    return meta, out, buf.getvalue()


def test_export_main_verifies(beam_only):
    """The command line exports the pipeline of the Config's weight file
    and holds each loaded program to the exported function run eagerly,
    bitwise."""
    meta, _, printed = beam_only
    assert meta["batch"] == 1 and meta["beam_n"] == BEAM
    assert printed.count("bitwise == the exported function run eagerly: True") == 2


def test_beam_only_artifact_refuses_sampling(exported, beam_only):
    """Without ``sample`` the artifact carries the beam programs alone: its
    ``sample_batch`` raises, and the server refuses ``decode="sample"``."""
    meta, out, _ = beam_only
    assert meta["sampling"] is False and sorted(meta["programs"]) == ["serving.pt2",
                                                                      "serving_u8.pt2"]
    served = ex.load_serving(out, "cpu")
    assert not served.supports_sampling
    with pytest.raises(ValueError, match="--sample"):
        served.sample_batch(np.zeros((1, SIZE, SIZE, 3), np.float32))
    with pytest.raises(ValueError, match="--sample"):
        pt_serve.make_server(exported["cfg"], port=0, pipeline=served, decode="sample")
    imgs = images_of(4, 3)
    assert_equal(served.predict_batch(imgs), exported["served"].predict_batch(imgs))


def test_beam_mismatch_rejected(exported):
    served = exported["served"]
    with pytest.raises(ValueError, match="beam_n"):
        served.predict_batch(np.zeros((1, SIZE, SIZE, 3), np.float32), beam_n=5)
    with pytest.raises(ValueError, match="images"):
        served.predict_batch(np.zeros((1, 64, 64, 3), np.float32))
    with pytest.raises(ValueError, match="empty"):
        served.predict_batch(np.zeros((0, SIZE, SIZE, 3), np.float32))


def test_apply_to_config(exported):
    served, meta = exported["served"], exported["meta"]
    cfg = served.apply_to_config(exported["cfg"].replace(image_input_size=512, decode_batch=64,
                                                         beam_search_n=8))
    assert (cfg.image_input_size, cfg.beam_search_n, cfg.decode_batch) == \
        (meta["image_size"], meta["beam_n"], meta["batch"])


def test_max_decode_rows_guard(exported, tmp_path):
    """A fused export whose decode rows exceed ``max_decode_rows`` is
    refused before any tracing (the live pipeline would chunk it; a
    program's batch is fixed); the non-fused route has no such ceiling."""
    pipe = exported["pipe"]
    with pytest.raises(ValueError, match="max_decode_rows"):
        ex.export_serving(pipe, str(tmp_path / "a"), batch=512)   # 1024 rows > 512
    assert not (tmp_path / "a").exists()
    mesh = dataclasses.replace(pipe.config.mesh, enabled=True)
    saved = pipe.config
    try:
        pipe.config = saved.replace(mesh=mesh)
        with pytest.raises(ValueError, match="mesh"):
            ex.export_serving(pipe, str(tmp_path / "b"))
    finally:
        pipe.config = saved


def test_caption_cli_from_artifact(exported, tmp_path):
    """``python -m fpn_mt_image_captioning_torch.caption --artifact=DIR``:
    the flag is parsed, the artifact served, its image size, beam and batch
    override the Config's; the captions are the artifact's."""
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    imgs = images_of(5, 3)
    for i, a in enumerate(imgs):
        Image.fromarray(a).save(img_dir / f"img{i}.png")
    out = tmp_path / "caps.json"
    results = pt_caption.cli([f"--images={img_dir}", f"--out={out}",
                              f"--artifact={exported['out']}", "--image_input_size=512",
                              "--beam_search_n=5", f"--result_dir={tmp_path}"], device="cpu")
    assert json.loads(out.read_text()) == results
    assert [r["caption"] for r in results] == exported["served"].caption(imgs)


def test_serve_from_artifact(exported):
    """``python -m fpn_mt_image_captioning_torch.serve --artifact=DIR``: the
    server of the command line runs on the artifact (health, a caption equal
    to the artifact's on the decoded image)."""
    srv, host, port = pt_serve.server_from_argv(
        [f"--artifact={exported['out']}", "--host=127.0.0.1", "--port=0",
         "--max_delay_ms=20", "--image_input_size=512"], device="cpu")
    assert (host, port, srv.cfg.image_input_size) == ("127.0.0.1", 0, SIZE)
    base, thread = start(srv)
    img = images_of(6, 1)[0]
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        status, body = post(base + "/caption", png_bytes(img))
    finally:
        srv.shutdown()
        srv.close()
        thread.join(timeout=60)
    assert health["backend"] == "cpu" and health["beam"] == BEAM
    assert status == 200 and body["caption"] == exported["served"].caption(img[None])[0]


def test_pre_uint8_artifact_normalizes_host_side(exported):
    """An artifact without uint8 programs, fed raw uint8, normalizes on the
    host onto its float program (a bare cast would feed 0..255)."""
    served = exported["served"]
    u8 = images_of(11, 2)
    as_float = u8.astype(np.float32) / 127.5 - 1.0
    saved = served.accepts_uint8
    try:
        served.accepts_uint8 = False
        got = served.predict_batch(u8)
    finally:
        served.accepts_uint8 = saved
    assert_equal(got, served.predict_batch(as_float))


def test_fold_chunk_seed_properties_and_jax():
    """The JAX package's properties (chunk 0 keeps the seed; no linear-fold
    collision class; int32 range), and the same integers as its function."""
    from fpn_mt_image_captioning_tpu.export import fold_chunk_seed as jx_fold

    fold = ex.fold_chunk_seed
    assert fold(5, 0) == 5
    assert len({fold(s, c) for s in range(64) for c in range(8)}) == 64 * 8
    for stride in (1, 1_000_003):
        assert all(fold(n, 1) != fold(n + stride, 0) for n in range(0, 2000, 97))
    seeds = (0, 1, 5, 11, -7, 2**31 - 1, -(2**31), 2**32 + 3, 123456789)
    for seed in seeds:
        for chunk in (0, 1, 2, 3, 9999, 2**20):
            v = fold(seed, chunk)
            assert -(2**31) <= v < 2**31 and v == jx_fold(seed, chunk)


# ---------------------------------------------------------------------------
# the port's own
# ---------------------------------------------------------------------------
def test_artifact_captions_equal_the_jax_pipeline(exported):
    """The cross-package anchor: the artifact's captions are the JAX
    package's ``Pipeline.predict_batch``'s on the same weights."""
    jpipe = exported["jpipe"]
    imgs = exported["images"]
    j_seqs, j_len = jpipe.predict_batch(imgs, beam_n=BEAM)
    got = exported["served"].predict_batch(imgs)
    assert_equal(got, (np.asarray(j_seqs), np.asarray(j_len)))
    captions = exported["served"].caption(imgs)
    assert captions == [jpipe.to_caption(s, n) for s, n in zip(j_seqs, j_len)]
    assert len(set(captions)) > 1   # not vacuous


def test_float32_weight_file_restores_under_flax(exported):
    """A float32 artifact's ``weights.msgpack`` restores under flax to the
    JAX pipeline's variables, bitwise."""
    from flax import serialization, traverse_util

    with open(os.path.join(exported["out"], "weights.msgpack"), "rb") as f:
        got = traverse_util.flatten_dict(serialization.msgpack_restore(f.read()), sep="/")
    want = traverse_util.flatten_dict(jax.device_get(exported["variables"]), sep="/")
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == np.float32 and got[k].tobytes() == np.asarray(v).tobytes(), k


def test_beam_graph_holds_each_kernel_op(exported):
    """Both beam programs hold each decode kernel's custom operator exactly
    ``max_len`` × its launches a step, so an export on the card runs the
    hand-written kernels, and no copy of a self-attention cache: the cache
    writes stay in place (the self-attention operator mutates its caches)."""
    meta = exported["meta"]
    want = {k: MAX_LEN * n for k, n in PER_STEP.items()}
    for fname in ("serving.pt2", "serving_u8.pt2"):
        assert meta["programs"][fname]["kernel_nodes"] == want
    for fname in ("sampling.pt2", "sampling_nucleus.pt2"):   # the non-fused step
        assert meta["programs"][fname]["kernel_nodes"] == {}
    ep = torch.export.load(os.path.join(exported["out"], "serving_u8.pt2"))
    lpad = fd.round_up(MAX_LEN + 1, 8)
    cache = (exported["cfg"].num_layers, lpad, BATCH * BEAM, exported["cfg"].d_model)
    mutated, copies = 0, []
    for node in ep.graph.nodes:
        if node.op != "call_function":
            continue
        name = str(node.target)
        if "decoder_self_attention" in name:
            mutated += 1
            assert tuple(node.args[1].meta["val"].shape) == cache
        if any(w in name for w in ("clone", "copy")):
            val = node.meta.get("val")
            copies.append(tuple(val.shape) if isinstance(val, torch.Tensor) else None)
    assert mutated == MAX_LEN * 2 and cache not in copies


def test_operators_call_the_real_wrappers(monkeypatch):
    """The operators stay bound to ``ops/fused_decoder.py``'s wrappers after
    the probes make their second, empty-bodied instance of that module (it
    registers nothing): an exported program never launches the probe's
    kernels."""
    from fpn_mt_image_captioning_torch.ops import fused_backbone as fb
    from fpn_mt_image_captioning_torch.ops import operators, probes

    calls = []
    for mod in (fd, probes.TRIVIAL_DECODER):
        real = mod.decoder_linear_reference
        monkeypatch.setattr(mod, "decoder_linear_reference", lambda *a, _m=mod, _r=real, **k: (
            calls.append(_m), _r(*a, **k))[1])
    torch.ops.fpn_mt.decoder_linear(torch.ones(2, 8), torch.ones(8, 8), torch.zeros(8),
                                    "none", False)
    assert calls == [fd]
    assert set(operators.OP_NAMES) == {*fd.KERNELS, *fb.KERNELS}


@pytest.mark.parametrize("route", ["fused", "non_fused", "sample"])
def test_fixed_steps_equal_early_stop(exported, route):
    """``fixed_steps`` (all ``max_len`` steps, no host sync) gives the early
    stop's result, on images where some rows end early and some never end."""
    pipe = exported["pipe"]
    model = pipe.transformer
    imgs = np.concatenate([exported["images"], images_of(8, 5)])
    with torch.no_grad():
        enc = pipe.encode(imgs)
        if route == "sample":
            run = lambda fixed: sample_decode(
                model, enc, torch.Generator().manual_seed(2), max_len=MAX_LEN,
                start_token=pipe.start_token, end_token=pipe.end_token,
                temperature=np.linspace(0.3, 1.5, len(imgs)), top_p=0.9, fixed_steps=fixed)
        else:
            run = lambda fixed: beam_search(
                model, enc, beam_n=BEAM, max_len=MAX_LEN, start_token=pipe.start_token,
                end_token=pipe.end_token, fused=route == "fused",
                packed=pipe.packed if route == "fused" else None, fixed_steps=fixed)[:2]
        early, fixed = run(False), run(True)
    assert_equal([t.numpy() for t in fixed], [t.numpy() for t in early])
    lengths = early[1].numpy()
    assert lengths.min() < MAX_LEN and lengths.max() == MAX_LEN


def test_subprocess_load_constructs_no_transformer(exported, tmp_path):
    """A fresh process loads the artifact and captions without importing
    the model module."""
    imgs = images_of(9, 3)
    np.save(tmp_path / "imgs.npy", imgs)
    code = ("import json, sys\nimport numpy as np\n"
            "from fpn_mt_image_captioning_torch.export import load_serving\n"
            "s = load_serving(sys.argv[1], 'cpu')\n"
            "caps = s.caption(np.load(sys.argv[2]))\n"
            "print(json.dumps({'captions': caps, 'model': "
            "'fpn_mt_image_captioning_torch.models.transformer' in sys.modules}))\n")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code, exported["out"], str(tmp_path / "imgs.npy")],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"captions": exported["served"].caption(imgs), "model": False}


def test_device_mismatch_raises(exported, tmp_path, monkeypatch):
    """The loader runs on the card by default and never falls back to the
    CPU; an artifact runs only on the device type it was exported for."""
    out = exported["out"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.load_serving(out)
    with pytest.raises(ValueError, match="exported for cpu"):
        ex.load_serving(out, "cuda")
    card = tmp_path / "card"
    shutil.copytree(out, card, ignore=shutil.ignore_patterns("*.pt2"))
    meta = json.loads((card / "artifact.json").read_text())
    (card / "artifact.json").write_text(json.dumps(dict(meta, platforms=["cuda"])))
    with pytest.raises(ValueError, match="exported for cuda"):
        ex.load_serving(str(card), "cpu")
