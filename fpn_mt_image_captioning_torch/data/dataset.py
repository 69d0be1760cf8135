"""The data layer (the port's copy of
``fpn_mt_image_captioning_tpu/data/dataset.py``): ``load_image`` and
``load_image_batch``, the training dataset (``get_coco_images_dataset``,
``CocoCaptionDataset`` with its buffered shuffle, ``DecodedImageCache``,
``_Prefetcher``), the validation iterators (``COCO_Images_ImageID``,
``get_coco_images_captions_generator``) and the additional-info sidecar.
Over several processes each reads its own shard of the corpus
(``parallel.multihost.process_shard``): the training shards are strided and
of equal length, the validation shards strided over one shuffled order.

Parity with the reference's data layer: captions wrapped ``<start> ...
<end>`` and empty (``' '``) captions dropped; the tokenizer fit on the
captions before the punctuation spacing (``re.sub(r'([.,])', r" \1 ",
...)``) that the sequences are computed on; ``max_seq_len`` the longest
tokenized caption, post-padding; ``set_len = ceil(captions / batch_size)``.
"""

from __future__ import annotations

import json
import math
import os
import queue
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from random import Random
from typing import Iterator

import numpy as np

from ..config import Config
from .coco import COCO
from .tokenizer import (REFERENCE_FILTERS, Tokenizer, load_tokenizer_from_path, pad_sequences,
                        store_tokenizer_to_path)

__all__ = ["load_image", "load_image_batch", "get_coco_images_dataset", "CocoCaptionDataset",
           "DecodedImageCache", "COCO_Images_ImageID", "get_coco_images_captions_generator",
           "store_additional_info", "load_additional_info", "load_max_seq_len",
           "calc_max_length"]


def calc_max_length(tensor) -> int:
    return max(len(t) for t in tensor)


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


class DecodedImageCache:
    """Disk cache of decoded+resized images — the tf.data ``.cache()``
    equivalent (the reference's pipeline re-decodes every PNG every epoch,
    ``the reference's dataset.py:89-92``; so does ours without this).

    PNG inflate + resize dominates host input cost (~330 ms/image/core at
    IU X-ray sizes — ``benchmarks/input_pipeline.py``); a multi-epoch training
    run pays it once here, then every later epoch streams from a uint8 memmap
    at memory bandwidth.

    Layout: ``<path>.bin`` — (N, S, S, 3) uint8, C-order — plus ``<path>.json``,
    a manifest carrying the image size and a fingerprint of the exact file list
    (paths + sizes + mtimes). Any mismatch — different files, different order,
    touched images, different size — rebuilds; the manifest is written only
    after a complete build, so an interrupted build is invalid, never stale.

    Precision: pixels are stored as uint8 — bit-identical to the PIL decode
    path (PIL's bilinear resize itself emits uint8). The native C++ loader
    keeps float precision through its resize, so cached reads may differ from
    it by at most half an 8-bit quantum (0.5/127.5 in [-1, 1] units) — the
    same quantization every source image already went through once.
    """

    def __init__(self, path: str, img_paths: list[str], image_size: int,
                 num_workers: int = 16):
        self.bin_path = path + ".bin"
        self.manifest_path = path + ".json"
        self.img_paths = img_paths
        self.image_size = image_size
        self.num_workers = num_workers
        self._mm: np.memmap | None = None

    def _fingerprint(self) -> str:
        import hashlib

        h = hashlib.sha1()
        h.update(str(self.image_size).encode())
        for p in self.img_paths:
            st = os.stat(p)
            h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}\n".encode())
        return h.hexdigest()

    @property
    def shape(self) -> tuple[int, int, int, int]:
        s = self.image_size
        return (len(self.img_paths), s, s, 3)

    def valid(self) -> bool:
        try:
            with open(self.manifest_path) as f:
                manifest = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False
        try:  # a missing/truncated .bin (e.g. /tmp cleanup) means rebuild,
            size = os.path.getsize(self.bin_path)  # not crash
        except OSError:
            return False
        return (
            manifest.get("fingerprint") == self._fingerprint()
            and size == int(np.prod(self.shape))
        )

    def build(self, chunk: int = 64) -> None:
        os.makedirs(os.path.dirname(self.bin_path) or ".", exist_ok=True)
        mm = np.memmap(self.bin_path, dtype=np.uint8, mode="w+", shape=self.shape)
        for start in range(0, len(self.img_paths), chunk):
            batch = self.img_paths[start : start + chunk]
            imgs = load_image_batch(batch, self.image_size, self.num_workers)
            mm[start : start + len(batch)] = np.clip(
                np.rint((imgs + 1.0) * 127.5), 0, 255
            ).astype(np.uint8)
        mm.flush()
        del mm
        with open(self.manifest_path, "w") as f:
            json.dump(
                {"fingerprint": self._fingerprint(), "shape": self.shape}, f
            )

    def ensure(self) -> None:
        if self._mm is None:
            if not self.valid():
                self.build()
            self._mm = np.memmap(
                self.bin_path, dtype=np.uint8, mode="r", shape=self.shape
            )

    def read(self, idxs: list[int], as_uint8: bool = False) -> np.ndarray:
        """Batch of images as float32 in [-1, 1] (same formula as decode).

        ``as_uint8=True`` returns the stored bytes directly — no host-side
        inflation pass and 4× fewer bytes to the device; the model normalizes
        on-device (``models.layers.normalize_images``)."""
        self.ensure()
        raw = self._mm[idxs]
        if as_uint8:
            return np.ascontiguousarray(raw)
        return raw.astype(np.float32) / 127.5 - 1.0


class _Prefetcher:
    """Background-thread prefetch queue (replaces tf.data's AUTOTUNE prefetch).

    The producer never blocks indefinitely: every ``put`` polls a stop event,
    so a consumer that abandons the iterator mid-epoch (early break, exception)
    releases the thread — and the decoded batches it pins — via ``close()``,
    which garbage collection also triggers (the thread closes over the queue
    and event, not ``self``, so an abandoned iterator stays collectable)."""

    _END = object()

    def __init__(self, it: Iterator, depth: int = 2):
        q = self._q = queue.Queue(maxsize=depth)
        stop = self._stop = threading.Event()
        errbox = self._errbox = []
        self._done = False  # terminal: no further q.get (it could block forever)
        end = _Prefetcher._END

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def run():
            try:
                for item in it:
                    if not put(item):
                        return  # consumer gone
            except BaseException as e:  # propagate into consumer
                errbox.append(e)
            finally:
                put(end)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def close(self):
        self._done = True
        self._stop.set()
        try:  # drain so a producer blocked in q.put observes the stop promptly
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        self.close()

    def __iter__(self):
        return self

    def __next__(self):
        # terminal after exhaustion / a propagated error / close(): the
        # producer is gone, so another q.get() would block forever
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._END:
            self._done = True
            self._stop.set()
            if self._errbox:
                raise self._errbox[0]
            raise StopIteration
        return item


class CocoCaptionDataset:
    """Iterable of ``(images [B,S,S,3] f32 — or uint8 with ``as_uint8=True``,
    normalized on-device — captions [B,L] i32)`` batches.

    Equivalent of the reference's
    ``from_tensor_slices → map(load_image) → shuffle(1000) → batch(10) → prefetch``
    chain (``dataset.py:89-92``), rebuilt with a thread pool + prefetch thread.
    The order of an epoch is the JAX package's, from the same ``seed``.
    """

    def __init__(
        self,
        img_paths: list[str],
        captions_token: np.ndarray,
        batch_size: int,
        image_size: int,
        shuffle_buffer: int = 1000,
        seed: int = 0,
        num_workers: int = 16,
        cache_path: str | None = None,
        as_uint8: bool = False,
        shard_count: int = 1,
        shard_index: int = 0,
    ):
        assert len(img_paths) == len(captions_token)
        if shard_count > 1:
            # equal-length shards: every rank must take as many (collective)
            # train steps an epoch, so the strided shards are all cut to the
            # shortest (fewer than shard_count examples go unused)
            n_equal = len(img_paths) // shard_count
            img_paths = img_paths[shard_index::shard_count][:n_equal]
            captions_token = captions_token[shard_index::shard_count][:n_equal]
        self.img_paths = img_paths
        self.captions_token = captions_token
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle_buffer = shuffle_buffer
        self.seed = seed
        self.num_workers = num_workers
        self.as_uint8 = as_uint8
        self._epoch = 0
        self._cache = None
        if cache_path:
            if shard_count > 1:   # each shard caches its own images
                cache_path = f"{cache_path}.shard{shard_index}of{shard_count}"
            self._cache = DecodedImageCache(
                cache_path, img_paths, image_size, num_workers
            )

    def __len__(self) -> int:
        n = len(self.img_paths)
        return math.ceil(n / self.batch_size)

    def _shuffled_order(self) -> list[int]:
        """Buffered shuffle à la tf.data.shuffle(buffer): a sliding reservoir."""
        rng = Random((self.seed, self._epoch).__hash__())
        n = len(self.img_paths)
        order, buf = [], []
        for i in range(n):
            buf.append(i)
            if len(buf) > self.shuffle_buffer:
                j = rng.randrange(len(buf))
                order.append(buf.pop(j))
        while buf:
            order.append(buf.pop(rng.randrange(len(buf))))
        return order

    def __iter__(self):
        order = self._shuffled_order()
        self._epoch += 1

        def gen():
            for start in range(0, len(order), self.batch_size):
                idxs = order[start : start + self.batch_size]
                if self._cache is not None:
                    imgs = self._cache.read(idxs, as_uint8=self.as_uint8)
                else:
                    imgs = load_image_batch(
                        [self.img_paths[i] for i in idxs],
                        self.image_size,
                        self.num_workers,
                        as_uint8=self.as_uint8,
                    )
                yield imgs, self.captions_token[idxs]

        return _Prefetcher(gen(), depth=2)


def get_coco_images_dataset(
    dataDir: str,
    dataType: str,
    n_test: int | None = None,
    config: Config | None = None,
):
    """Build the training dataset. Returns ``(dataset, max_seq_len, set_len)``.

    Parity port of reference ``get_coco_images_dataset`` (``dataset.py:29-94``).
    Over several processes the dataset is this process' shard
    (``process_shard``); the primary alone stores a tokenizer it fits. The
    dataset yields uint8 images: the model normalizes them on the device.
    """
    from ..parallel.multihost import barrier, is_primary, process_shard

    cfg = config or Config()
    annFile = f"{dataDir}/annotations/captions_{dataType}.json"
    coco = COCO(annFile)

    annIds = coco.getAnnIds()[:n_test] if n_test is not None else coco.getAnnIds()
    anns = coco.loadAnns(annIds)
    anns = [ann for ann in anns if ann["caption"] != " "]
    captions = ["<start> " + ann["caption"] + " <end>" for ann in anns]
    imgIds = [ann["image_id"] for ann in anns]

    tokenizer_file = Path(cfg.tokenizer_filename)
    if tokenizer_file.is_file():
        tokenizer = load_tokenizer_from_path(tokenizer_file)
        print("Tokenizer is loaded from", tokenizer_file)
    else:
        tokenizer = Tokenizer(
            num_words=cfg.top_k, oov_token="unk", filters=REFERENCE_FILTERS
        )
        tokenizer.fit_on_texts(captions)
        tokenizer.add_padding_token()
        if is_primary():   # every rank fits the same one; one writes it
            tokenizer_file.parent.mkdir(parents=True, exist_ok=True)
            tmp = f"{cfg.tokenizer_filename}.tmp"
            store_tokenizer_to_path(tokenizer, tmp)
            os.replace(tmp, cfg.tokenizer_filename)
    barrier("tokenizer")   # the file exists for every rank's pipeline after this

    # punctuation spacing applied AFTER fit — reference quirk (dataset.py:73)
    captions = [re.sub(r"([.,])", r" \1 ", caption) for caption in captions]
    captions_token = tokenizer.texts_to_sequences(captions)

    set_len = math.ceil(len(captions_token) / cfg.batch_size)
    max_seq_len = calc_max_length(captions_token)
    captions_token = pad_sequences(captions_token, padding="post")

    imgs = coco.loadImgs(imgIds)
    img_paths = [
        os.path.join(dataDir, "images", dataType, img["file_name"]) for img in imgs
    ]

    shard_index, shard_count = process_shard()
    dataset = CocoCaptionDataset(
        img_paths,
        captions_token,
        batch_size=cfg.batch_size,
        image_size=cfg.image_input_size,
        shuffle_buffer=cfg.buffer_size,
        seed=cfg.seed,
        cache_path=cfg.dataset_cache or None,
        # raw uint8 rows: the train forward normalizes on the device
        # (models/layers.py:normalize_images), 4× fewer bytes per step
        as_uint8=True,
        shard_count=shard_count,
        shard_index=shard_index,
    )
    return dataset, max_seq_len, set_len


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
    and ``iter_batches`` for batched decode. ``shard_count``/``shard_index``:
    a process' strided shard of the shuffled, truncated ids (the shards may
    differ in length by one; ``Pipeline.evaluate`` decodes them in lock
    step); sharded without a ``seed``, every process shuffles with seed 0,
    so the shards are disjoint and cover the split."""

    def __init__(self, dataDir: str, dataType: str, n_val: int | None = None,
                 image_size: int = 512, seed: int | None = None,
                 shard_count: int = 1, shard_index: int = 0):
        self.dataDir = dataDir
        self.dataType = dataType
        self.image_size = image_size
        self.coco = COCO(f"{dataDir}/annotations/captions_{dataType}.json")
        anns = [a for a in self.coco.loadAnns(self.coco.getAnnIds()) if a["caption"] != " "]
        self.imgIds = [a["image_id"] for a in anns]
        if shard_count > 1 and seed is None:
            seed = 0
        Random(seed).shuffle(self.imgIds)
        self.max_len = len(self.imgIds) if n_val is None else n_val
        self.imgIds = self.imgIds if n_val is None else self.imgIds[:n_val]
        if shard_count > 1:
            self.imgIds = self.imgIds[shard_index::shard_count]
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
