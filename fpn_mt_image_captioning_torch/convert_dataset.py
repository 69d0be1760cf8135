"""Convert the raw IU X-ray XML reports to COCO caption format with a random
val/train split (the port's copy of the repository's root
``convert_dataset.py``):

    python -m fpn_mt_image_captioning_torch.convert_dataset
        [--xml_dir=...] [--image_dir=...] [--amount_of_validation=100]
        [any Config --key=value, e.g. --datadir=datasets/iuxray]
"""

from __future__ import annotations

import sys

from .config import Config
from .data.convert import convert_store_to_coco_val_train

__all__ = ["main", "DEFAULT_XML_DIR", "DEFAULT_IMAGE_DIR"]

DEFAULT_XML_DIR = "datasets/iuxray_raw/annotations_raw_xml/nlmcxr/ecgen-radiology/"
DEFAULT_IMAGE_DIR = "datasets/iuxray_raw"


def main(argv: list[str]) -> None:
    xml_dir, image_dir = DEFAULT_XML_DIR, DEFAULT_IMAGE_DIR
    passthrough = []
    for arg in argv:
        if arg.startswith("--xml_dir="):
            xml_dir = arg.split("=", 1)[1]
        elif arg.startswith("--image_dir="):
            image_dir = arg.split("=", 1)[1]
        else:
            passthrough.append(arg)
    cfg = Config.from_flags(passthrough)
    convert_store_to_coco_val_train(xml_dir, image_dir, cfg.amount_of_validation, cfg)


if __name__ == "__main__":
    main(sys.argv[1:])
