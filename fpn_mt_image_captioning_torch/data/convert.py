"""IU X-ray raw XML reports → COCO caption JSON (the port's copy of
``fpn_mt_image_captioning_tpu/data/convert.py``; ``tests/test_torch_train_loop.py``
holds the two to the same bytes).

Behavior contract (the reference's ``convert_dataset.py:12-107``): random
val/train split of the XML file list; caption = ``impression + ' ' + findings``; one
COCO image + annotation + license record per ``<parentImage>`` with ids numbered from
1000 (licenses from 1); PNGs copied into ``<datadir>/images/<split>/``; JSON written
to ``<datadir>/annotations/captions_<split>.json``.

Design: each XML report is parsed into a small immutable record
(:class:`ReportEntry` per ``<parentImage>``), and the COCO JSON is assembled from the
flattened entry stream in a single pass.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import xml.etree.ElementTree as ET
from shutil import copyfile
from typing import Iterable, Sequence

from ..config import Config

__all__ = ["convert_store_to_coco_val_train", "convert_store_format_to_coco"]

log = logging.getLogger(__name__)

_FIRST_RECORD_ID = 1000  # reference numbering: image/annotation ids start at 1000


@dataclasses.dataclass(frozen=True)
class ReportHeader:
    """Report-level metadata; the first parsed report fills the COCO ``info`` block."""

    description: str | None
    date_created: str | None
    contributor: str | None

    def as_coco_info(self) -> dict:
        return {
            "description": self.description,
            "date_created": self.date_created,
            "contributor": self.contributor,
        }


@dataclasses.dataclass(frozen=True)
class ReportEntry:
    """One ``<parentImage>`` occurrence: a PNG plus its caption and license."""

    png_name: str
    caption: str
    license_url: str | None
    license_name: str | None


def _field(root: ET.Element, xpath: str) -> str | None:
    node = root.find(xpath)
    return None if node is None else node.text


def _parse_report(xml_path: str) -> tuple[ReportHeader, list[ReportEntry]]:
    root = ET.parse(xml_path).getroot()
    header = ReportHeader(
        description=_field(root, "./title"),
        date_created=_field(root, "./articleDate"),
        contributor=_field(root, "./publisher"),
    )
    # missing sections degrade to "" (reference concatenates possibly-None text)
    impression = _field(root, './/AbstractText[@Label="IMPRESSION"]') or ""
    findings = _field(root, './/AbstractText[@Label="FINDINGS"]') or ""
    caption = impression + " " + findings
    url = _field(root, "./licenseURL")
    name = _field(root, "./licenseType")
    entries = [
        ReportEntry(node.attrib["id"] + ".png", caption, url, name)
        for node in root.findall("./parentImage")
    ]
    return header, entries


def convert_store_to_coco_val_train(
    report_dir: str,
    image_dir: str,
    amount_of_validation: int = 500,
    config: Config | None = None,
    seed: int | None = None,
) -> None:
    """Shuffle the report list, carve off a validation slice, convert both splits."""
    cfg = config or Config()
    # sort first: os.listdir order is filesystem-dependent, so an unsorted
    # shuffle would make the seeded val/train split non-reproducible across
    # machines/copies of the report directory
    reports = sorted(os.listdir(report_dir))
    random.Random(seed).shuffle(reports)

    log.info("Begin conversion to COCO format...")
    for split, files in (
        (cfg.datatype_val, reports[:amount_of_validation]),
        (cfg.datatype_train, reports[amount_of_validation:]),
    ):
        convert_store_format_to_coco(files, report_dir, image_dir, cfg.datadir, split)
    log.info("End conversion to COCO format...")


def convert_store_format_to_coco(
    report_files: Sequence[str],
    report_dir: str,
    image_dir: str,
    out_root: str,
    split_name: str,
    image_id_start: int = _FIRST_RECORD_ID,
    annotation_id_start: int = _FIRST_RECORD_ID,
) -> None:
    """Convert one split's reports and write ``captions_<split>.json``.

    PNGs referenced by the reports are copied from
    ``<image_dir>/images/nlmcxr/`` into ``<out_root>/images/<split>/``.
    """
    split_image_dir = os.path.join(out_root, "images", split_name)
    os.makedirs(split_image_dir, exist_ok=True)
    os.makedirs(os.path.join(out_root, "annotations"), exist_ok=True)

    info: dict = {}
    licenses: list[dict] = []
    images: list[dict] = []
    annotations: list[dict] = []

    for offset, entry in enumerate(
        _iter_entries(report_files, report_dir, info)
    ):
        image_id = image_id_start + offset
        annotation_id = annotation_id_start + offset
        license_id = 1 + offset
        licenses.append(
            {"url": entry.license_url, "id": license_id, "name": entry.license_name}
        )
        images.append(
            {"license": license_id, "file_name": entry.png_name, "id": image_id}
        )
        annotations.append(
            {"image_id": image_id, "id": annotation_id, "caption": entry.caption}
        )
        source_png = os.path.join(image_dir, "images", "nlmcxr", entry.png_name)
        copyfile(source_png, os.path.join(split_image_dir, entry.png_name))

    payload = {
        "info": info,
        "licenses": licenses,
        "images": images,
        "annotations": annotations,
    }
    out_path = os.path.join(out_root, "annotations", f"captions_{split_name}.json")
    with open(out_path, "w") as fh:
        json.dump(payload, fh)


def _iter_entries(
    report_files: Sequence[str], report_dir: str, info: dict
) -> Iterable[ReportEntry]:
    """Yield every image entry across the reports, filling ``info`` from the
    first report parsed (reference fills ``info`` once, convert_dataset.py:55-60)."""
    for name in report_files:
        if not name.endswith(".xml"):
            continue
        header, entries = _parse_report(os.path.join(report_dir, name))
        if not info:
            info.update(header.as_coco_info())
        yield from entries
