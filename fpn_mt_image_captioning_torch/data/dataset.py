"""Image files, the validation iterators and run metadata (the port's copy
of the functions of ``fpn_mt_image_captioning_tpu/data/dataset.py`` that
captioning and evaluation need): ``load_image`` and ``load_image_batch``,
``COCO_Images_ImageID`` and ``get_coco_images_captions_generator``, and the
additional-info sidecar.

The training input pipeline is not ported yet."""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from random import Random

import numpy as np

from ..config import Config
from .coco import COCO
from .tokenizer import load_tokenizer_from_path

__all__ = ["load_image", "load_image_batch", "COCO_Images_ImageID",
           "get_coco_images_captions_generator", "store_additional_info",
           "load_additional_info", "load_max_seq_len"]


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


def get_coco_images_captions_generator(dataDir: str, dataType: str,
                                       config: Config | None = None):
    """Yield ``(img, [tokenized caption, ...])`` per image of the split.
    Needs a fitted tokenizer at ``config.tokenizer_filename``."""
    cfg = config or Config()
    coco = COCO(f"{dataDir}/annotations/captions_{dataType}.json")
    tokenizer_file = Path(cfg.tokenizer_filename)
    if not tokenizer_file.is_file():
        raise FileNotFoundError(f"tokenizer is not yet created in {cfg.tokenizer_filename}")
    tokenizer = load_tokenizer_from_path(tokenizer_file)
    for imgId in coco.getImgIds():
        anns = [a for a in coco.loadAnns(coco.getAnnIds(imgIds=imgId)) if a["caption"] != " "]
        captions = ["<start> " + a["caption"] + " <end>" for a in anns]
        captions_token = tokenizer.texts_to_sequences(captions)
        img_path = os.path.join(dataDir, "images", dataType, coco.loadImgs(imgId)[0]["file_name"])
        img, _ = load_image(img_path, None, cfg.image_input_size)
        yield img, captions_token


class COCO_Images_ImageID:
    """Shuffled validation iterator yielding ``(img [S,S,3], imgId)`` one at a
    time, truncated to ``n_val`` (one id per caption, as in the JAX package),
    and ``iter_batches`` for batched decode. Sharding the ids over processes
    is not ported."""

    def __init__(self, dataDir: str, dataType: str, n_val: int | None = None,
                 image_size: int = 512, seed: int | None = None):
        self.dataDir = dataDir
        self.dataType = dataType
        self.image_size = image_size
        self.coco = COCO(f"{dataDir}/annotations/captions_{dataType}.json")
        anns = [a for a in self.coco.loadAnns(self.coco.getAnnIds()) if a["caption"] != " "]
        self.imgIds = [a["image_id"] for a in anns]
        Random(seed).shuffle(self.imgIds)
        self.max_len = len(self.imgIds) if n_val is None else n_val
        self.imgIds = self.imgIds if n_val is None else self.imgIds[:n_val]
        self.max_len = min(self.max_len, len(self.imgIds))
        self.iterIndex = 0

    def _path(self, imgId) -> str:
        return os.path.join(self.dataDir, "images", self.dataType,
                            self.coco.loadImgs(imgId)[0]["file_name"])

    def __iter__(self):
        self.iterIndex = 0
        return self

    def __next__(self):
        if self.iterIndex >= self.max_len or self.iterIndex >= len(self.imgIds):
            raise StopIteration
        imgId = self.imgIds[self.iterIndex]
        self.iterIndex += 1
        return load_image(self._path(imgId), None, self.image_size)[0], imgId

    def iter_batches(self, batch_size: int, num_workers: int = 16, as_uint8: bool = False):
        """Yield ``(imgs [B,S,S,3], imgIds list, valid count)``; the last
        batch is padded by repeating its final image, so every batch has one
        shape. ``as_uint8`` gives the resized bytes (the pipeline normalizes
        on the device)."""
        ids = self.imgIds[: self.max_len]
        for start in range(0, len(ids), batch_size):
            chunk = ids[start : start + batch_size]
            paths = [self._path(i) for i in chunk]
            paths += [paths[-1]] * (batch_size - len(paths))
            yield load_image_batch(paths, self.image_size, num_workers, as_uint8=as_uint8), \
                chunk, len(chunk)


def store_additional_info(d: dict, filename: str) -> None:
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    with open(filename, "w") as outfile:
        json.dump(d, outfile)


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
