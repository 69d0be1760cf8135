"""Minimal pure-Python COCO caption API.

The reference depends on ``pycocotools.coco.COCO`` for caption-annotation indexing
(the reference's ``dataset.py:8,45-49,85``) and on its ``loadRes`` for result files.
pycocotools is a C-extension package built for detection (masks, boxes); captioning
needs only the JSON index, so this framework ships a dependency-free reimplementation
of the exact surface used: ``COCO(annFile)``, ``getAnnIds``, ``loadAnns``,
``getImgIds``, ``loadImgs``, ``loadRes``, ``showAnns``.

The port's copy of ``fpn_mt_image_captioning_tpu/data/coco.py``
(``tests/test_torch_metrics.py`` holds the two equal).
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from typing import Any, Iterable

__all__ = ["COCO"]


def _as_list(x) -> list:
    if x is None:
        return []
    if isinstance(x, (list, tuple, set)):
        return list(x)
    return [x]


class COCO:
    def __init__(self, annotation_file: str | None = None):
        self.dataset: dict[str, Any] = {}
        self.anns: dict[int, dict] = {}
        self.imgs: dict[int, dict] = {}
        self.img_to_anns: dict[int, list[dict]] = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            self.create_index()

    def create_index(self) -> None:
        self.anns = {}
        self.imgs = {}
        self.img_to_anns = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img

    # -- query -----------------------------------------------------------
    def getAnnIds(self, imgIds=None) -> list[int]:
        imgIds = _as_list(imgIds)
        if not imgIds:
            anns = self.dataset.get("annotations", [])
        else:
            anns = [a for i in imgIds for a in self.img_to_anns.get(i, [])]
        return [a["id"] for a in anns]

    def getImgIds(self) -> list[int]:
        return list(self.imgs.keys())

    def loadAnns(self, ids: Iterable[int] | int | None = None) -> list[dict]:
        return [self.anns[i] for i in _as_list(ids)]

    def loadImgs(self, ids: Iterable[int] | int | None = None) -> list[dict]:
        return [self.imgs[i] for i in _as_list(ids)]

    # -- results ----------------------------------------------------------
    def loadRes(self, resFile) -> "COCO":
        """Load a caption result file (list of {"image_id", "caption"}) as a COCO
        object sharing this object's image table — mirrors pycocotools' loadRes
        caption branch, used by MetricEval (the reference's dataset.py:283)."""
        res = COCO()
        res.dataset = {"images": [img for img in self.dataset.get("images", [])]}
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = copy.deepcopy(resFile)
        assert isinstance(anns, list), "results must be a list of annotations"
        ann_img_ids = {a["image_id"] for a in anns}
        known = set(self.getImgIds())
        assert ann_img_ids <= known, "result image ids must exist in the ground-truth set"
        res.dataset["images"] = [img for img in res.dataset["images"] if img["id"] in ann_img_ids]
        for i, ann in enumerate(anns):
            ann["id"] = i + 1
        res.dataset["annotations"] = anns
        res.create_index()
        return res

    # -- display ----------------------------------------------------------
    def showAnns(self, anns: list[dict]) -> None:
        for ann in anns:
            print(ann.get("caption", ""))
