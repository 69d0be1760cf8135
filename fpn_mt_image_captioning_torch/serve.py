"""HTTP captioning server with dynamic batching (port of the repository's root
``serve.py``): a standard-library HTTP server that coalesces concurrent
single-image requests into fixed-size ``Pipeline.predict_batch`` calls (or,
with ``decode="sample"``, ``Pipeline.sample_batch`` calls) on the CUDA card.

  * Fixed batch: every device batch is padded to ``serve_batch`` (default
    ``Config.decode_batch``), so each call has the shape the warm-up ran.
  * Dynamic batching: the batcher thread takes the first queued request,
    then waits up to ``max_delay_ms`` (default 10) for the batch to fill.
  * Host work off the card's path: image decode on the HTTP handler threads
    (ThreadingHTTPServer), detokenization on the batcher thread.

Endpoints:
  POST /caption        image bytes (PNG, JPEG, anything PIL reads) in the
                       body → {"caption": str, "tokens": int, "latency_ms"}.
                       Under --decode=sample, optional ?temperature=&top_p=
                       query parameters apply per request (per-row inputs of
                       one batch); a finite temperature >= 0 and
                       0 < top_p <= 1, else 400; on a beam server they are a
                       400
  GET  /healthz        liveness and model/config info
  GET  /stats          request/batch counters, batch fill, and the span
                       summaries of ``utils.profiling.REGISTRY`` (``steps``,
                       ``mean_ms``, ``p50_ms``, ``p90_ms``, ``p99_ms``,
                       ``self_ms``): ``device_batch_ms`` (the ``serve.batch``
                       spans: a device batch, from its call to its host
                       arrays), ``queue_wait_ms`` (``serve.queue_wait``: a
                       request, from its arrival until the batcher takes its
                       batch), and ``spans``, each ``predict.*`` and
                       ``beam.*`` span of the caption path
  POST /stats/reset    zero the counters and those spans (a batch in flight
                       across the reset does not count into the new window)

Overload: the request queue is bounded (``max_queue``, default 8 ×
serve_batch); beyond it a request gets 503 + Retry-After. An undecodable
body is a 400, an unknown path a 404.

    python -m fpn_mt_image_captioning_torch.serve [--port=8500]
        [--serve_batch=64] [--max_delay_ms=10] [--max_queue=N]
        [--request_timeout_s=1800] [--beam_search_n=8] [--fused_backbone=true]
        [--decode=beam|sample] [--sample_seed=N] [--artifact=DIR]
        [any Config --key=value]

The weights are those of ``Pipeline.from_config``: the Flax msgpack file
``--transformer_weight_path`` where it exists, else the latest checkpoint
under ``--transformer_checkpoint_path`` (Orbax or the port's own), else the
seeded init. A sampling batch is seeded with
``sample_seed`` + the batch's sequence number. With ``--artifact=DIR`` it
serves an exported artifact (``export.load_serving``, on the card) without
the model code; its image size, beam and batch override the Config's, and
``--decode=sample`` needs an artifact exported with ``--sample``.
"""

from __future__ import annotations

import io
import json
import math
import signal
import sys
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

import numpy as np

from .config import Config
from .data.dataset import load_image
from .train.pipeline import Pipeline
from .utils.profiling import REGISTRY, annotate

# the caption path's spans, which /stats shows under ``spans``
CAPTION_SPANS = ("predict.", "beam.")

__all__ = ["QueueFull", "DynamicBatcher", "CaptionServer", "decode_image_bytes",
           "make_server", "server_from_argv", "main"]


def decode_image_bytes(data: bytes, image_size: int, as_uint8: bool = False) -> np.ndarray:
    """A request body → the resized image, as ``data.dataset.load_image``
    gives it for a file (PIL decode, bilinear resize; uint8 with
    ``as_uint8``, else [-1, 1] float32)."""
    return load_image(io.BytesIO(data), image_size=image_size, as_uint8=as_uint8)[0]


class QueueFull(RuntimeError):
    """``DynamicBatcher.submit`` when the queue holds ``max_queue`` images;
    the HTTP layer answers 503 + Retry-After."""


class DynamicBatcher:
    """Coalesces submitted images into fixed-size ``predict_batch`` calls on a
    dedicated thread; callers get a Future of ``(caption, tokens)``. With
    ``decode="sample"`` the call is ``sample_batch``, each row with its
    request's temperature and top_p."""

    def __init__(self, pipeline: Pipeline, batch: int, max_delay_ms: float,
                 decode: str = "beam", sample_seed: int = 0, max_queue: int | None = None):
        self.pipeline = pipeline
        self.batch = batch
        self.max_delay_s = max_delay_ms / 1000.0
        self.decode = decode
        self.sample_seed = sample_seed
        # backpressure: beyond this many queued images submit() raises
        self.max_queue = 8 * batch if max_queue is None else max_queue
        # (image, temperature, top_p, future, arrival on time.perf_counter_ns)
        self._queue: list[tuple[np.ndarray, float, float, Future, int]] = []
        self._lock = threading.Condition()
        self._closed = False
        self.stats = {"requests": 0, "batches": 0, "images_padded": 0, "errors": 0,
                      "rejected": 0}
        self._batch_seq = 0   # the sampling seed's counter; reset_stats keeps it
        # bumped by reset_stats: a batch in flight across a reset must not
        # count into the freshly zeroed window
        self._stats_gen = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def reset_stats(self) -> None:
        """Zero the counters and the spans that ``/stats`` shows (POST
        /stats/reset): ``serve.*``, ``predict.*`` and ``beam.*``; the
        process' other spans are kept. The sampling seed's sequence goes on:
        a replayed seed would replay captions."""
        with self._lock:
            for k in self.stats:
                self.stats[k] = 0
            REGISTRY.reset("serve.", *CAPTION_SPANS)
            self._stats_gen += 1

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def submit(self, img: np.ndarray, temperature: float = 1.0, top_p: float = 1.0) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if len(self._queue) >= self.max_queue:
                self.stats["rejected"] += 1
                raise QueueFull(f"{len(self._queue)} images already queued "
                                f"(max_queue={self.max_queue}); retry later")
            self._queue.append((img, temperature, top_p, fut, time.perf_counter_ns()))
            self.stats["requests"] += 1
            self._lock.notify()
        return fut

    def _take_batch(self):
        """Block for the first request, then fill until the batch is full or
        ``max_delay_s`` has passed since the first arrival."""
        with self._lock:
            while not self._queue and not self._closed:
                self._lock.wait(timeout=0.2)
            if not self._queue:
                return None   # closed and drained
            deadline = time.monotonic() + self.max_delay_s
            while len(self._queue) < self.batch and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._lock.wait(timeout=remaining)
            items, self._queue = self._queue[: self.batch], self._queue[self.batch:]
            taken = time.perf_counter_ns()
            for *_, arrived in items:
                REGISTRY.record("serve.queue_wait", arrived, taken)
            return items

    def _worker(self):
        while True:
            items = self._take_batch()
            if items is None:
                return
            with self._lock:
                gen = self._stats_gen
            pad = self.batch - len(items)
            failed = False
            try:
                # batch assembly inside the try: a failure here must fail
                # these futures, not kill the only batcher thread
                imgs = np.stack([im for im, *_ in items])
                if pad:
                    imgs = np.concatenate([imgs, np.zeros((pad, *imgs.shape[1:]), imgs.dtype)])
                with annotate("serve.batch", cpu=True):
                    if self.decode == "sample":
                        temps = np.ones(self.batch, np.float32)
                        tps = np.ones(self.batch, np.float32)
                        for i, (_, temp, tp, *_) in enumerate(items):
                            temps[i], tps[i] = temp, tp
                        seqs, lengths = self.pipeline.sample_batch(
                            imgs, temperature=temps,
                            # no nucleus (and no per-step sort) where no row asks for it
                            top_p=None if (tps >= 1.0).all() else tps,
                            # a seed a batch: identical requests in two batches differ,
                            # and a server replays its own sequence
                            seed=self.sample_seed + self._batch_seq)
                    else:
                        seqs, lengths = self.pipeline.predict_batch(imgs)
                for i, (*_, fut, _) in enumerate(items):
                    if not fut.done():   # close() may have failed it already
                        fut.set_result((self.pipeline.to_caption(seqs[i], lengths[i]),
                                        int(lengths[i])))
            except BaseException as e:  # noqa: BLE001 - every caller must unblock
                failed = True
                for *_, fut, _ in items:
                    if not fut.done():
                        fut.set_exception(e)
            with self._lock:
                self._batch_seq += 1
                if gen == self._stats_gen:
                    self.stats["batches"] += 1
                    self.stats["images_padded"] += pad
                    if failed:
                        self.stats["errors"] += 1

    def close(self):
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        self._thread.join(timeout=30)
        with self._lock:
            leftovers, self._queue = self._queue, []
        for *_, fut, _ in leftovers:
            if not fut.done():
                fut.set_exception(RuntimeError("server shutting down"))


class CaptionServer(ThreadingHTTPServer):
    daemon_threads = True
    # listen backlog: the default of 5 resets connections when a burst of
    # clients connects at once
    request_queue_size = 128

    def __init__(self, addr, pipeline: Pipeline, cfg: Config, batch: int,
                 max_delay_ms: float, request_timeout_s: float = 600.0,
                 decode: str = "beam", sample_seed: int = 0, max_queue: int | None = None):
        self.pipeline = pipeline
        self.cfg = cfg
        # the pipeline normalizes uint8 on the card (4× smaller transfer)
        self.input_uint8 = bool(getattr(pipeline, "accepts_uint8", False))
        self.batcher = DynamicBatcher(pipeline, batch, max_delay_ms, decode=decode,
                                      sample_seed=sample_seed, max_queue=max_queue)
        self.request_timeout_s = request_timeout_s
        super().__init__(addr, _Handler)

    def close(self):
        self.batcher.close()
        self.pipeline.close()
        self.server_close()   # release the listening socket (shutdown() does not)


def _rounded(summary: dict) -> dict:
    return {k: round(v, 2) for k, v in summary.items()}


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server: CaptionServer

    def _reply(self, code: int, payload: dict, extra_headers: dict[str, str] | None = None):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):   # quiet: the counters live at /stats
        pass

    def do_GET(self):
        srv = self.server
        if self.path == "/healthz":
            self._reply(200, {
                "status": "ok",
                "backend": str(getattr(srv.pipeline, "device", "unknown")),
                "serve_batch": srv.batcher.batch,
                "decode": srv.batcher.decode,
                "beam": srv.cfg.beam_search_n,
                "image_size": srv.cfg.image_input_size,
                "fused_backbone": getattr(srv.pipeline, "fused_backbone", getattr(
                    srv.pipeline, "backbone_packed", None) is not None),
            })
        elif self.path == "/stats":
            with srv.batcher._lock:
                st = dict(srv.batcher.stats)
            done = st["batches"] * srv.batcher.batch - st["images_padded"]
            st["mean_batch_fill"] = round(done / st["batches"], 2) if st["batches"] else 0.0
            st["queue_depth"] = srv.batcher.queue_depth()
            st["max_queue"] = srv.batcher.max_queue
            st["device_batch_ms"] = _rounded(REGISTRY.summary("serve.batch"))
            st["queue_wait_ms"] = _rounded(REGISTRY.summary("serve.queue_wait"))
            st["spans"] = {name: _rounded(REGISTRY.summary(name)) for name in REGISTRY.names()
                           if name.startswith(CAPTION_SPANS)}
            self._reply(200, st)
        else:
            self._reply(404, {"error": f"no such path {self.path}"})

    def do_POST(self):
        parts = urlsplit(self.path)
        length = int(self.headers.get("Content-Length", 0))

        def drain():   # an unread body would corrupt HTTP/1.1 keep-alive framing
            if length:
                self.rfile.read(length)

        if parts.path == "/stats/reset":
            drain()
            self.server.batcher.reset_stats()
            self._reply(200, {"status": "reset"})
            return
        if parts.path != "/caption":
            drain()
            self._reply(404, {"error": f"no such path {self.path}"})
            return
        srv = self.server
        query = parse_qs(parts.query)

        def reject(msg):
            drain()
            self._reply(400, {"error": msg})

        try:
            temperature = float(query.get("temperature", ["1.0"])[0])
            top_p = float(query.get("top_p", ["1.0"])[0])
            # NaN passes plain comparisons (nan < 0 is False) and would poison
            # its row's logits: finite is required explicitly
            if not math.isfinite(temperature) or temperature < 0 or not (0 < top_p <= 1):
                raise ValueError("finite temperature >= 0 and 0 < top_p <= 1 required")
        except ValueError as e:
            reject(f"bad sampling params: {e}")
            return
        if srv.batcher.decode != "sample" and ("temperature" in query or "top_p" in query):
            reject("sampling params require the server to run with --decode=sample "
                   "(this one decodes beam search)")
            return
        try:
            if not length:
                self._reply(400, {"error": "empty body; POST raw image bytes"})
                return
            img = decode_image_bytes(self.rfile.read(length), srv.cfg.image_input_size,
                                     as_uint8=srv.input_uint8)
        except Exception as e:
            self._reply(400, {"error": f"undecodable image: {e}"})
            return
        try:
            t0 = time.perf_counter()
            caption, ntok = srv.batcher.submit(img, temperature, top_p).result(
                timeout=srv.request_timeout_s)
            self._reply(200, {"caption": caption, "tokens": ntok,
                              "latency_ms": round((time.perf_counter() - t0) * 1000, 1)})
        except QueueFull as e:
            # shed load: tell the client to back off about one batch time
            ms = REGISTRY.summary("serve.batch").get("p50_ms", 100.0)
            self._reply(503, {"error": f"overloaded: {e}"},
                        extra_headers={"Retry-After": str(max(1, round(ms / 1000)))})
        except Exception as e:
            self._reply(500, {"error": f"{type(e).__name__}: {e}"})


def make_server(cfg: Config, host: str = "127.0.0.1", port: int = 8500,
                serve_batch: int | None = None, max_delay_ms: float = 10.0,
                pipeline: Pipeline | None = None, decode: str = "beam",
                sample_seed: int = 0, max_queue: int | None = None,
                request_timeout_s: float = 600.0) -> CaptionServer:
    """Build (but do not run) the server; tests use ``port=0`` and
    ``serve_forever`` in a thread. ``pipeline=None`` builds
    ``Pipeline.from_config(cfg)`` on the card. ``decode="sample"`` serves
    sampled captions (per-request ``?temperature=&top_p=``)."""
    if decode not in ("beam", "sample"):
        raise ValueError(f"decode must be 'beam' or 'sample', got {decode!r}")
    if decode == "sample" and pipeline is not None and not getattr(
            pipeline, "supports_sampling", hasattr(pipeline, "sample_batch")):
        raise ValueError("--decode=sample needs a live Pipeline or an artifact exported with "
                         "`export --sample` (this artifact carries only the beam-search "
                         "program)")
    if pipeline is None:
        pipeline = Pipeline.from_config(cfg)
    batch = serve_batch or max(cfg.decode_batch, 1)
    return CaptionServer((host, port), pipeline, cfg, batch, max_delay_ms,
                         request_timeout_s=request_timeout_s, decode=decode,
                         sample_seed=sample_seed, max_queue=max_queue)


def server_from_argv(argv: list[str], device=None) -> tuple[CaptionServer, str, int]:
    """The server of the command line, not yet running, and its host and
    port: ``make_server`` on the flags, on the artifact of ``--artifact``
    (loaded on ``device``, default the card) where one is given."""
    host, port, serve_batch, max_delay_ms = "0.0.0.0", 8500, None, 10.0
    decode, sample_seed, max_queue, request_timeout_s = "beam", 0, None, 1800.0
    artifact = None
    passthrough = []
    for arg in argv:
        key, _, val = arg.partition("=")
        if key == "--max_queue":
            max_queue = int(val)
        elif key == "--request_timeout_s":
            request_timeout_s = float(val)
        elif key == "--port":
            port = int(val)
        elif key == "--host":
            host = val
        elif key == "--serve_batch":
            serve_batch = int(val)
        elif key == "--max_delay_ms":
            max_delay_ms = float(val)
        elif key == "--decode":
            decode = val
        elif key == "--sample_seed":
            sample_seed = int(val)
        elif key == "--artifact":
            artifact = val
        else:
            passthrough.append(arg)
    cfg = Config.from_flags(passthrough)
    pipeline = None
    if artifact:
        from .export import load_serving

        pipeline = load_serving(artifact, device)
        cfg = pipeline.apply_to_config(cfg)
    server = make_server(cfg, host, port, serve_batch, max_delay_ms, pipeline=pipeline,
                         decode=decode, sample_seed=sample_seed, max_queue=max_queue,
                         request_timeout_s=request_timeout_s)
    return server, host, port


def main(argv: list[str]) -> None:
    server, host, port = server_from_argv(argv)
    cfg, decode = server.cfg, server.batcher.decode

    # warm-up before accepting traffic: kernel builds and cuDNN plans
    warm = np.zeros((server.batcher.batch, cfg.image_input_size, cfg.image_input_size, 3),
                    np.uint8 if server.input_uint8 else np.float32)
    t0 = time.perf_counter()
    if decode == "sample":   # both sampling routes: without and with the nucleus
        server.pipeline.sample_batch(warm)
        server.pipeline.sample_batch(warm, top_p=np.full(warm.shape[0], 0.9, np.float32))
    else:
        server.pipeline.predict_batch(warm)
    print(f"warm-up done in {time.perf_counter() - t0:.1f}s")

    # SIGTERM: finish in-flight batches, refuse new work, release the card
    signal.signal(signal.SIGTERM,
                  lambda *_: threading.Thread(target=server.shutdown, daemon=True).start())
    print(f"serving on http://{host}:{port}  (batch={server.batcher.batch}, "
          f"decode={decode}, beam={cfg.beam_search_n}, "
          f"delay={1000 * server.batcher.max_delay_s:g}ms)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()


if __name__ == "__main__":
    main(sys.argv[1:])
