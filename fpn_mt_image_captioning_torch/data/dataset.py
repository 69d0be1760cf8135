"""Image files and run metadata for the serving path (the port's copy of the
functions of ``fpn_mt_image_captioning_tpu/data/dataset.py`` that the CLI and
the server need): ``load_image`` and ``load_image_batch``, and the
additional-info sidecar readers.

The training input pipeline is not ported yet."""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np

__all__ = ["load_image", "load_image_batch", "load_additional_info", "load_max_seq_len"]


def load_image(img_path, caption=None, image_size: int = 512, as_uint8: bool = False):
    """Decode → RGB → resize to (size, size) bilinear (PIL) → scale to
    [-1, 1]; with ``as_uint8`` the resized uint8 pixels instead (the pipeline
    normalizes on the device). ``img_path`` is a path or any file-like object
    PIL can open (the server feeds request bodies as ``io.BytesIO``).
    Returns ``(array, caption)``."""
    from PIL import Image

    with Image.open(img_path) as im:
        im = im.convert("RGB")
        if im.size != (image_size, image_size):
            im = im.resize((image_size, image_size), Image.BILINEAR)
        if as_uint8:
            return np.asarray(im, dtype=np.uint8), caption
        arr = np.asarray(im, dtype=np.float32)
    return arr / 127.5 - 1.0, caption


def load_image_batch(paths: list[str], image_size: int, num_workers: int = 16,
                     as_uint8: bool = False):
    """Batched decode + resize + normalize → (N, S, S, 3) float32 in [-1, 1],
    or uint8 with ``as_uint8``.

    The native loader first (``runtime/image_loader.cc``: PNG, PPM, PGM,
    half-pixel bilinear); PIL per image for what it rejects (JPEG, 16-bit or
    interlaced PNG) and for everything when it is unavailable. The native
    loader's float output is re-quantized for ``as_uint8``
    (``rint((x + 1)·127.5)``): exact where no resize is needed, within half
    a quantum of the resized value otherwise."""
    from ..runtime import native_loader

    if native_loader.available():
        out, ok = native_loader.decode_batch(paths, image_size, num_workers)
        if not ok.all():
            bad = np.nonzero(~ok)[0]
            with ThreadPoolExecutor(max_workers=num_workers) as pool:
                for i, img in zip(bad, pool.map(
                        lambda j: load_image(paths[j], None, image_size)[0], bad)):
                    out[i] = img
        if as_uint8:
            return np.clip(np.rint((out + 1.0) * 127.5), 0, 255).astype(np.uint8)
        return out
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        imgs = list(pool.map(
            lambda p: load_image(p, None, image_size, as_uint8=as_uint8)[0], paths))
    return np.stack(imgs)


def load_additional_info(filename: str) -> dict:
    """Run-metadata sidecar (max_seq_len, best-CIDEr epoch, ...). A MISSING
    file returns ``{}`` — the legitimate first-run state — but an unreadable
    or corrupt file RAISES with the path."""
    try:
        with open(filename) as infile:
            return json.load(infile)
    except FileNotFoundError:
        return {}
    except (OSError, json.JSONDecodeError) as e:
        raise ValueError(
            f"additional-info file unreadable or corrupt: {filename!r} ({e})"
        ) from e


def load_max_seq_len(filename: str) -> int:
    """The tokenized-caption length the model was built for, from the
    additional-info sidecar — with a clear error naming the path when the
    training run hasn't written it."""
    info = load_additional_info(filename)
    if "max_seq_len" not in info:
        raise FileNotFoundError(
            f"no max_seq_len in additional-info file {filename!r} — train.py "
            "(or get_coco_images_dataset) writes it; pass the same "
            "--additional_filename the training run used"
        )
    return int(info["max_seq_len"])
