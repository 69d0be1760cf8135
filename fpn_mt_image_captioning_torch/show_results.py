"""Print the ground-truth and the generated captions of every image in a
result file (the port's counterpart of the repository's root
``show_results.py``); with matplotlib installed, each image is shown too, or
saved beside the result file under a non-interactive backend.

    python -m fpn_mt_image_captioning_torch.show_results [--result_dir=results]
        [--datadir=datasets/iuxray] [any Config --key=value]
"""

from __future__ import annotations

from .config import Config
from .data.metrics import MetricEval

__all__ = ["main"]


def main(cfg: Config) -> None:
    metric_eval = MetricEval(cfg.datadir, cfg.datatype_val)
    img_ids = metric_eval.coco.loadRes(cfg.result_file).getImgIds()
    for i, img_id in enumerate(img_ids):
        print("---", i, img_id)
        metric_eval.print_result(img_id, cfg.result_file)
        print()


if __name__ == "__main__":
    main(Config.from_flags())
