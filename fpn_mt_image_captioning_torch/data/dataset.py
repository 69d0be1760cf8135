"""Run-metadata sidecar readers (the port's copy of the two functions of
``fpn_mt_image_captioning_tpu/data/dataset.py`` that the serving path needs).

Image-file loading and the training input pipeline are not ported yet."""

from __future__ import annotations

import json

__all__ = ["load_additional_info", "load_max_seq_len"]


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
