"""Batched captioning CLI of the port: caption a directory (or one file) of
images on the CUDA card (port of the repository's root ``caption.py``).

    python -m fpn_mt_image_captioning_torch.caption --images=DIR
        [--out=results/serving_captions_result.json] [--latency[=N]]
        [--artifact=DIR] [--decode_batch=64] [--beam_search_n=8]
        [--fused_backbone=true] [any Config --key=value]

Images are decoded and resized on host threads (the native loader, PIL for
what it rejects) while the card captions the previous batch; every batch is
``decode_batch`` images, the tail zero-padded. Writes a JSON list of
``{"file", "caption"}`` and prints the throughput; ``--latency[=N]`` also
times N single-image requests end to end.

The pipeline comes from ``Pipeline.from_config``: the tokenizer and
``max_seq_len`` files of the Config, and the weights of the Flax msgpack file
``--transformer_weight_path`` where it exists (the JAX package's
``Pipeline.save_weights``); without it seeded weights, or a refusal where an
Orbax checkpoint exists (reading one is not ported). With ``--artifact=DIR``
it serves an exported artifact instead (``export.load_serving``, on the
card), whose image size, beam and batch override the Config's.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .config import Config
from .data.dataset import load_image_batch
from .train.pipeline import Pipeline

__all__ = ["IMAGE_EXTS", "list_images", "measure_latency", "main", "parse_args", "cli"]

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".ppm", ".bmp")


def list_images(path: str) -> list[str]:
    if not os.path.exists(path):
        raise SystemExit(f"no such file or directory: {path}")
    if os.path.isfile(path):
        return [path]
    files = sorted(os.path.join(path, f) for f in os.listdir(path)
                   if f.lower().endswith(IMAGE_EXTS))
    if not files:
        raise SystemExit(f"no images under {path}")
    return files


def measure_latency(pipeline, files, image_size: int, n: int) -> dict:
    """End-to-end single-request latency: host image load → encode + beam
    decode on the card → caption string, over ``n`` requests after one
    warm-up request."""
    reps = [files[i % len(files)] for i in range(n)]
    u8 = bool(getattr(pipeline, "accepts_uint8", False))
    img = load_image_batch(reps[:1], image_size, as_uint8=u8)
    seqs, lengths = pipeline.predict_batch(img)
    pipeline.to_caption(seqs[0], lengths[0])

    times = []
    for f in reps:
        t0 = time.perf_counter()
        img = load_image_batch([f], image_size, as_uint8=u8)
        seqs, lengths = pipeline.predict_batch(img)
        pipeline.to_caption(seqs[0], lengths[0])
        times.append((time.perf_counter() - t0) * 1000)
    times.sort()
    return {
        "metric": "end-to-end single-request latency",
        "unit": "ms",
        "n": n,
        "p50_ms": round(times[max(math.ceil(0.5 * len(times)) - 1, 0)], 2),
        "p90_ms": round(times[max(math.ceil(0.9 * len(times)) - 1, 0)], 2),   # nearest rank
        "min_ms": round(times[0], 2),
    }


def _write_results(results: list[dict], out_path: str | None, cfg: Config) -> str:
    if out_path is None:
        out_path = os.path.join(cfg.result_dir, "serving_captions_result.json")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(results, f, indent=1)
    print(f"wrote {out_path}")
    return out_path


def main(cfg: Config, images_path: str, out_path: str | None, latency_n: int = 0,
         pipeline=None) -> list[dict]:
    files = list_images(images_path)
    owns_pipeline = pipeline is None
    if owns_pipeline:
        pipeline = Pipeline.from_config(cfg)

    batch = max(cfg.decode_batch, 1)
    chunks = [files[i : i + batch] for i in range(0, len(files), batch)]
    results: list[dict] = []
    u8 = bool(getattr(pipeline, "accepts_uint8", False))
    # one prefetch thread; load_image_batch fans out its own decode workers
    prefetcher = ThreadPoolExecutor(max_workers=1)

    def submit(chunk):
        return prefetcher.submit(load_image_batch, chunk, cfg.image_input_size, as_uint8=u8)

    def captioned(chunk, imgs):
        if len(chunk) < batch:   # pad the tail: every batch has one shape
            imgs = np.concatenate([imgs, np.zeros((batch - len(chunk), *imgs.shape[1:]),
                                                  imgs.dtype)])
        seqs, lengths = pipeline.predict_batch(imgs)
        return [{"file": f, "caption": pipeline.to_caption(seqs[i], lengths[i])}
                for i, f in enumerate(chunk)]

    # an image-load or decode failure mid-run must not lose captions already
    # computed, nor leak the prefetch thread
    try:
        # the first batch is the warm-up (kernel builds, cuDNN plans), untimed
        results.extend(captioned(chunks[0], submit(chunks[0]).result()))

        # the host loads batch i+1 while the card captions batch i
        t0 = time.perf_counter()
        if len(chunks) > 1:
            pending = submit(chunks[1])
            for ci in range(1, len(chunks)):
                imgs = pending.result()
                if ci + 1 < len(chunks):
                    pending = submit(chunks[ci + 1])
                results.extend(captioned(chunks[ci], imgs))
        dt = time.perf_counter() - t0
        timed_images = len(files) - len(chunks[0])
        if timed_images:
            print(f"captioned {len(files)} images ({timed_images} post-warm-up in {dt:.2f}s = "
                  f"{timed_images / dt:.1f} img/s end-to-end, batch={batch}, "
                  f"beam={cfg.beam_search_n})")
        else:
            print(f"captioned {len(files)} images (single batch incl. warm-up; "
                  f"batch={batch}, beam={cfg.beam_search_n})")
        if latency_n:
            print(json.dumps(measure_latency(pipeline, files, cfg.image_input_size, latency_n)))
        _write_results(results, out_path, cfg)
    except BaseException:
        if results:   # partial results are still worth keeping
            try:
                _write_results(results, out_path, cfg)
            except Exception as write_err:   # never mask the root cause
                print(f"failed to write partial results: {write_err}", file=sys.stderr)
        raise
    finally:
        prefetcher.shutdown(wait=False, cancel_futures=True)
        if owns_pipeline:   # never close a caller's pipeline
            pipeline.close()
    return results


def parse_args(argv: list[str]):
    """``(cfg, images, out, latency_n, artifact)`` from the command line
    (``artifact`` None without ``--artifact``)."""
    images, out, latency_n, artifact = None, None, 0, None
    passthrough = []
    for arg in argv:
        if arg.startswith("--images="):
            images = arg.split("=", 1)[1]
        elif arg.startswith("--out="):
            out = arg.split("=", 1)[1]
        elif arg.startswith("--latency="):
            latency_n = int(arg.split("=", 1)[1])
        elif arg == "--latency":
            latency_n = 16
        elif arg.startswith("--artifact="):
            artifact = arg.split("=", 1)[1]
        else:
            passthrough.append(arg)
    if images is None:
        raise SystemExit("usage: python -m fpn_mt_image_captioning_torch.caption "
                         "--images=<dir-or-file> [--out=...] [--latency[=N]] [--artifact=DIR] "
                         "[--key=value ...]")
    return Config.from_flags(passthrough), images, out, latency_n, artifact


def cli(argv: list[str], device=None) -> list[dict]:
    """The command line: ``parse_args``, the artifact loaded where one is
    given (on ``device``, default the card), then ``main``."""
    cfg, images, out, latency_n, artifact = parse_args(argv)
    served = None
    if artifact:
        from .export import load_serving

        served = load_serving(artifact, device)
        cfg = served.apply_to_config(cfg)
    return main(cfg, images, out, latency_n=latency_n, pipeline=served)


if __name__ == "__main__":
    cli(sys.argv[1:])
