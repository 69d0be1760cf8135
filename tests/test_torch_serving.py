"""The port's CLI (``fpn_mt_image_captioning_torch/caption.py``) and HTTP
server (``.../serve.py``) on the CPU: the CLI writes the same caption JSON as
the JAX package's ``caption.main`` on the same perturbed weights (those of
``tests/test_torch_slice.py``), and the server answers health, single,
burst, error and overload requests with the offline captions. In
``decode="sample"`` the server answers bad sampling parameters, and
sampling parameters sent to a beam server, with the status and error text
of the root ``serve.py``, and a temperature-0 request with the greedy
caption that the root server gives.

The JAX side is a thin pipeline around the package's own ``encode``,
non-fused ``beam_search`` and ``sample_decode`` (``caption.main`` and the
root server take any object with ``predict_batch``, ``sample_batch`` and
``to_caption``); its PNG files are read by the JAX package's loader, the
port's by its own, exact at the model's size."""

import io
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
from PIL import Image

import caption as jx_caption
import serve as jx_serve
from fpn_mt_image_captioning_tpu.config import Config as JxConfig
from fpn_mt_image_captioning_tpu.decode.beam_search import beam_search as jx_beam_search
from fpn_mt_image_captioning_tpu.decode.beam_search import greedy_decode as jx_greedy
from fpn_mt_image_captioning_tpu.decode.beam_search import sample_decode as jx_sample_decode
from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
from fpn_mt_image_captioning_torch import caption as pt_caption
from fpn_mt_image_captioning_torch import serve as pt_serve
from fpn_mt_image_captioning_torch.data.tokenizer import Tokenizer, store_tokenizer_to_path
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from test_torch_slice import BEAM, CFG, MAX_LEN, SIZE, fit, slice_variables

N_FILES, BATCH = 5, 2   # three CLI batches, the last one padded


class JaxPipe:
    """The JAX package's encode + beam search (and sampling) behind the
    pipeline interface of ``caption.main`` and the root server."""

    accepts_uint8 = True

    def __init__(self, jx, jtok, variables):
        self.jtok, self.variables, self.jx = jtok, variables, jx
        self.start, self.end = jtok.word_index["<start>"], jtok.word_index["<end>"]
        self.encode = jax.jit(lambda v, x: jx.apply(v, x, train=False,
                                                    method=JxTransformer.encode))

    def predict_batch(self, images):
        enc = self.encode(self.variables, images)
        seqs, lengths, _ = jx_beam_search(self.jx, self.variables, enc, beam_n=BEAM,
                                          max_len=MAX_LEN, start_token=self.start,
                                          end_token=self.end, fused=False)
        return np.asarray(seqs), np.asarray(lengths)

    def sample_batch(self, images, *, seed=0, temperature=1.0, top_k=0, top_p=None):
        enc = self.encode(self.variables, images)
        seqs, lengths = jx_sample_decode(
            self.jx, self.variables, enc, jax.random.PRNGKey(seed), max_len=MAX_LEN,
            start_token=self.start, end_token=self.end, temperature=temperature,
            top_k=top_k, top_p=top_p)
        return np.asarray(seqs), np.asarray(lengths)

    def greedy_captions(self, images):
        enc = self.encode(self.variables, images)
        seqs, lengths = jx_greedy(self.jx, self.variables, enc, max_len=MAX_LEN,
                                  start_token=self.start, end_token=self.end)
        return [self.to_caption(s, n) for s, n in zip(np.asarray(seqs), np.asarray(lengths))]

    def close(self):
        pass

    def to_caption(self, seq, length):
        return self.jtok.sequences_to_texts([[int(t) for t in seq[:length]]])[0]


def png_bytes(arr: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jx, jtok, variables, images = slice_variables()
    root = tmp_path_factory.mktemp("serving")
    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.default_rng(21)
    arrays = np.concatenate([images, rng.integers(0, 256, (N_FILES - len(images), SIZE, SIZE, 3),
                                                  dtype=np.uint8)])
    for i, a in enumerate(arrays):
        Image.fromarray(a).save(img_dir / f"img{i}.png")
    pipe = Pipeline(fit(Tokenizer), MAX_LEN, CFG.replace(decode_batch=BATCH), variables,
                    device="cpu")
    return dict(jx=jx, jtok=jtok, variables=variables, arrays=arrays, img_dir=img_dir,
                root=root, pipe=pipe)


@pytest.fixture(scope="module")
def offline(world):
    """The port's CLI over the image directory: {file name: caption}."""
    cfg = CFG.replace(decode_batch=BATCH, result_dir=str(world["root"] / "pt"))
    results = pt_caption.main(cfg, str(world["img_dir"]), None, pipeline=world["pipe"])
    return {r["file"].rsplit("/", 1)[-1]: r["caption"] for r in results}, cfg


def test_cli_writes_the_jax_captions(world, offline):
    _, cfg = offline
    jcfg = JxConfig(image_input_size=SIZE, decode_batch=BATCH, beam_search_n=BEAM,
                    result_dir=str(world["root"] / "jx"))
    jx_caption.main(jcfg, str(world["img_dir"]), None,
                    pipeline=JaxPipe(world["jx"], world["jtok"], world["variables"]))
    out = "serving_captions_result.json"
    got = json.loads((world["root"] / "pt" / out).read_text())
    want = json.loads((world["root"] / "jx" / out).read_text())
    assert [r["file"] for r in got] == [r["file"] for r in want]
    assert got == want
    assert len(got) == N_FILES and len({r["caption"] for r in got}) > 1   # not vacuous


def test_cli_captions_equal_predict_batch(world, offline):
    captions, _ = offline
    pipe = world["pipe"]
    seqs, lengths = pipe.predict_batch(world["arrays"])
    assert [captions[f"img{i}.png"] for i in range(N_FILES)] == [
        pipe.to_caption(seqs[i], lengths[i]) for i in range(N_FILES)]


def test_cli_latency_report(world, capsys):
    cfg = CFG.replace(decode_batch=BATCH, result_dir=str(world["root"] / "lat"))
    pt_caption.main(cfg, str(world["img_dir"] / "img0.png"), None, latency_n=2,
                    pipeline=world["pipe"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-2])
    assert report["n"] == 2 and report["min_ms"] > 0 and report["p90_ms"] >= report["p50_ms"]


def test_cli_artifact_flag_raises(tmp_path):
    """``--artifact=DIR`` is parsed, and served from (tests/test_torch_export.py
    runs the CLI on an artifact); a directory that holds no artifact raises
    when the CLI loads it, before any image is read."""
    cfg, images, out, n, artifact = pt_caption.parse_args(["--images=x", "--artifact=dir"])
    assert (images, artifact) == ("x", "dir")
    with pytest.raises(FileNotFoundError, match="artifact.json"):
        pt_caption.cli([f"--images={tmp_path}", f"--artifact={tmp_path}"], device="cpu")
    cfg, images, out, n, artifact = pt_caption.parse_args(
        ["--images=d", "--out=o.json", "--latency", "--beam_search_n=2"])
    assert (images, out, n, cfg.beam_search_n, artifact) == ("d", "o.json", 16, 2, None)


@pytest.mark.parametrize("what", ["checkpoint", "retinanet"])
def test_existing_weights_raise_instead_of_seeded_serving(tmp_path, what):
    """Weights the port cannot read raise when the serving pipeline is
    built, as they do in the JAX package; it does not serve seeded weights
    in their place: a checkpoint step that holds neither the port's file
    nor an Orbax store (Orbax counts the directory as a step, and its
    restore fails; a readable one restores, tests/test_torch_orbax.py), and
    a pretrained Keras ``.h5`` path with no file there (``OSError``, as
    JAX's h5py raises; a file there is read and imported,
    tests/test_torch_hdf5.py)."""
    if what == "checkpoint":
        ckpt = tmp_path / "ckpt"
        (ckpt / "100").mkdir(parents=True)
        cfg = CFG.replace(transformer_checkpoint_path=str(ckpt))
        raised = pytest.raises(FileNotFoundError, match="step 100 .* holds neither")
    else:
        cfg = CFG.replace(transformer_checkpoint_path=str(tmp_path / "none"),
                          retinanet_weight_path=str(tmp_path / "r.h5"))
        raised = pytest.raises(OSError)
    with raised:
        Pipeline.from_config(cfg, device="cpu")
    img = tmp_path / "a.png"
    Image.fromarray(np.zeros((SIZE, SIZE, 3), np.uint8)).save(img)
    with raised:
        pt_caption.main(cfg, str(img), str(tmp_path / "out.json"))
    with raised:
        pt_serve.make_server(cfg, port=0)


def test_from_config_builds_a_seeded_pipeline(tmp_path, world):
    tok = tmp_path / "tok.json"
    store_tokenizer_to_path(fit(Tokenizer), str(tok))
    (tmp_path / "info.json").write_text(json.dumps({"max_seq_len": MAX_LEN}))
    cfg = CFG.replace(tokenizer_filename=str(tok), additional_filename=str(tmp_path / "info.json"),
                      transformer_checkpoint_path=str(tmp_path / "empty"))
    pipe = Pipeline.from_config(cfg, device="cpu")
    assert pipe.max_seq_len == MAX_LEN and pipe.device.type == "cpu"
    seqs, lengths = pipe.predict_batch(world["arrays"][:1])
    assert seqs.shape == (1, MAX_LEN)
    pipe.close()


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def server(world):
    srv = pt_serve.make_server(CFG, port=0, serve_batch=4, max_delay_ms=150.0,
                               pipeline=world["pipe"])
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()
    srv.batcher.close()
    srv.server_close()
    thread.join(timeout=30)


def post(base, data, path="/caption"):
    req = urllib.request.Request(base + path, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, json.loads(r.read())


def http_error(fn) -> urllib.error.HTTPError:
    with pytest.raises(urllib.error.HTTPError) as info:
        fn()
    return info.value


def test_healthz(server):
    _, base = server
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        body = json.loads(r.read())
    assert body["status"] == "ok" and body["backend"] == "cpu"
    assert (body["serve_batch"], body["decode"], body["beam"]) == (4, "beam", BEAM)
    assert body["fused_backbone"] is False


def test_single_request_matches_offline(server, world, offline):
    _, base = server
    status, body = post(base, png_bytes(world["arrays"][1]))
    assert status == 200 and body["caption"] == offline[0]["img1.png"]
    assert body["tokens"] >= 0 and body["latency_ms"] > 0


def test_burst_is_batched_and_matches_offline(server, world, offline):
    srv, base = server
    post(base, b"", path="/stats/reset")
    order = [i % N_FILES for i in range(8)]
    with ThreadPoolExecutor(8) as pool:
        replies = list(pool.map(lambda i: post(base, png_bytes(world["arrays"][i])), order))
    assert all(s == 200 for s, _ in replies)
    assert [b["caption"] for _, b in replies] == [offline[0][f"img{i}.png"] for i in order]
    with urllib.request.urlopen(base + "/stats", timeout=60) as r:
        stats = json.loads(r.read())
    assert stats["requests"] == 8 and stats["errors"] == 0
    assert stats["batches"] < 8 and stats["mean_batch_fill"] > 1   # coalesced
    assert stats["device_batch_ms"]["steps"] == stats["batches"]


def test_bad_requests_are_400(server):
    _, base = server
    assert http_error(lambda: post(base, b"this is not an image")).code == 400
    assert http_error(lambda: post(base, b"")).code == 400
    err = http_error(lambda: post(base, png_bytes(np.zeros((8, 8, 3), np.uint8)),
                                  path="/caption?temperature=0.5"))
    assert err.code == 400 and "--decode=sample" in json.loads(err.read())["error"]


def test_unknown_paths_are_404(server):
    _, base = server
    assert http_error(lambda: urllib.request.urlopen(base + "/nope", timeout=60)).code == 404
    assert http_error(lambda: post(base, b"x", path="/nope")).code == 404


def test_queue_full_is_503(server, world):
    srv, base = server
    old = srv.batcher.max_queue
    srv.batcher.max_queue = 0          # every submit is refused
    try:
        err = http_error(lambda: post(base, png_bytes(world["arrays"][0])))
        assert err.code == 503 and int(err.headers["Retry-After"]) >= 1
        with pytest.raises(pt_serve.QueueFull):
            srv.batcher.submit(world["arrays"][0])
    finally:
        srv.batcher.max_queue = old
    assert post(base, png_bytes(world["arrays"][0]))[0] == 200   # recovers


def test_sampling_and_artifact_raise(world):
    srv = pt_serve.make_server(CFG, port=0, pipeline=world["pipe"], decode="sample",
                               sample_seed=9)
    try:
        assert (srv.batcher.decode, srv.batcher.sample_seed) == ("sample", 9)
    finally:
        srv.batcher.close()
        srv.server_close()
    with pytest.raises(ValueError, match="decode"):
        pt_serve.make_server(CFG, port=0, pipeline=world["pipe"], decode="greedy")
    # --artifact is served (tests/test_torch_export.py); a directory that
    # holds no artifact raises before the server binds
    with pytest.raises(FileNotFoundError, match="artifact.json"):
        pt_serve.main([f"--artifact={world['root']}"])


# ---------------------------------------------------------------------------
# decode="sample", beside the root server
# ---------------------------------------------------------------------------
def start(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return thread, f"http://127.0.0.1:{srv.server_address[1]}"


def stop(srv, thread):
    srv.shutdown()
    srv.batcher.close()
    srv.server_close()
    thread.join(timeout=30)


@pytest.fixture(scope="module")
def servers(world):
    """The port's and the root ``serve.py``'s servers in ``decode="sample"``,
    and the root's in ``decode="beam"``, on the same weights."""
    jpipe = JaxPipe(world["jx"], world["jtok"], world["variables"])
    jcfg = JxConfig(image_input_size=SIZE, beam_search_n=BEAM)
    made = {
        "port": pt_serve.make_server(CFG, port=0, serve_batch=4, max_delay_ms=150.0,
                                     pipeline=world["pipe"], decode="sample", sample_seed=5),
        "root": jx_serve.make_server(jcfg, port=0, serve_batch=4, max_delay_ms=150.0,
                                     pipeline=jpipe, decode="sample", sample_seed=5),
        "root_beam": jx_serve.make_server(jcfg, port=0, serve_batch=4, max_delay_ms=150.0,
                                          pipeline=jpipe),
    }
    running = {k: start(srv) for k, srv in made.items()}
    yield {k: url for k, (_, url) in running.items()}, jpipe
    for k, srv in made.items():
        stop(srv, running[k][0])


BAD_PARAMS = ["top_p=0", "temperature=nan", "temperature=-1", "top_p=1.5", "temperature=abc",
              "top_p=inf"]


@pytest.mark.parametrize("query", BAD_PARAMS)
def test_sample_server_bad_params_as_root(servers, server, world, query):
    """A bad ``temperature``/``top_p`` is a 400 with the root server's text;
    the same parameter sent to a beam server (the port's and the root's)
    too."""
    urls, _ = servers
    body = png_bytes(world["arrays"][0])
    replies = {}
    for name, base in [("port", urls["port"]), ("root", urls["root"])]:
        err = http_error(lambda: post(base, body, path=f"/caption?{query}"))
        replies[name] = (err.code, json.loads(err.read())["error"])
    assert replies["port"] == replies["root"] and replies["port"][0] == 400
    assert replies["port"][1].startswith("bad sampling params: ")
    beam = {}
    for name, base in [("port", server[1]), ("root", urls["root_beam"])]:
        err = http_error(lambda: post(base, body, path="/caption?temperature=0.5&top_p=0.9"))
        beam[name] = (err.code, json.loads(err.read())["error"])
    assert beam["port"] == beam["root"] and beam["port"][0] == 400


def test_sample_server_temperature_zero_is_greedy(servers, world):
    """Mixed requests in one batch each get 200; the temperature-0 ones get
    the greedy caption, the root server's for the same PNG; /healthz says
    ``sample``."""
    urls, jpipe = servers
    greedy = jpipe.greedy_captions(world["arrays"][:3])
    queries = ["temperature=0", "temperature=0&top_p=0.5", "temperature=1.5&top_p=0.9",
               "temperature=0.7", "top_p=0.3", "temperature=0"]
    images = [0, 1, 2, 0, 1, 2]
    with ThreadPoolExecutor(len(queries)) as pool:
        replies = list(pool.map(
            lambda qi: post(urls["port"], png_bytes(world["arrays"][qi[1]]),
                            path=f"/caption?{qi[0]}"), zip(queries, images)))
    assert all(status == 200 for status, _ in replies)
    for (q, i), (_, body) in zip(zip(queries, images), replies):
        if q.startswith("temperature=0&") or q == "temperature=0":
            assert body["caption"] == greedy[i], q
    root = post(urls["root"], png_bytes(world["arrays"][2]), path="/caption?temperature=0")[1]
    assert root["caption"] == greedy[2] == replies[-1][1]["caption"]
    with urllib.request.urlopen(urls["port"] + "/healthz", timeout=60) as r:
        assert json.loads(r.read())["decode"] == "sample"
