"""Caption evaluation: MetricEval facade + the individual scorers.

The port's copy of ``fpn_mt_image_captioning_tpu/data/metrics/`` (pure Python,
no framework), so both packages score a result file to the same numbers. It
replaces the reference's ``MetricEval`` (its ``dataset.py:260-324``), which wraps pycocotools +
pycocoevalcap (Java-backed). Here the full metric suite — BLEU-1..4, METEOR,
ROUGE-L, CIDEr-D — is computed by the pure-Python scorers in this package;
``__call__`` returns the CIDEr value (the checkpoint-gating metric) and leaves
the complete results in ``.eval``, mirroring ``COCOEvalCap.eval``.

Known omission: pycocoevalcap's SPICE scorer (Java + Stanford CoreNLP
dependency parsing into scene-graph tuples) is NOT reimplemented — the
reference never reports it (its README table has no SPICE row and
``MetricEval`` returns only CIDEr), and a faithful scorer requires the CoreNLP
parser stack, unavailable offline. An approximation without a real parser
would produce numbers uncomparable to published SPICE values, which is worse
than absence.
"""

from __future__ import annotations

from ..coco import COCO
from .bleu import corpus_bleu
from .cider import CiderScorer, cider_d
from .meteor import meteor
from .ptb import ptb_tokenize, tokenize_corpus
from .rouge import rouge_l

__all__ = [
    "MetricEval",
    "COCOEvalCap",
    "corpus_bleu",
    "cider_d",
    "CiderScorer",
    "meteor",
    "rouge_l",
    "ptb_tokenize",
    "tokenize_corpus",
]


class COCOEvalCap:
    """Scores a result COCO against a ground-truth COCO (pycocoevalcap surface)."""

    def __init__(self, coco: COCO, cocoRes: COCO):
        self.coco = coco
        self.cocoRes = cocoRes
        self.params = {"image_id": coco.getImgIds()}
        self.eval: dict[str, float] = {}
        self.imgToEval: dict[int, dict[str, float]] = {}

    def evaluate(self) -> None:
        img_ids = self.params["image_id"]
        gts = {
            i: [a["caption"] for a in self.coco.img_to_anns[i]]
            for i in img_ids
            if self.coco.img_to_anns.get(i)
        }
        res = {
            i: [a["caption"] for a in self.cocoRes.img_to_anns[i]]
            for i in img_ids
            if self.cocoRes.img_to_anns.get(i)
        }
        # only score images present in both
        common = [i for i in gts if i in res]
        gts = {i: gts[i] for i in common}
        res = {i: res[i] for i in common}

        refs = tokenize_corpus(gts)
        hyps = tokenize_corpus(res)

        bleu_scores = corpus_bleu(hyps, refs)
        cider_corpus, cider_per_img = CiderScorer().compute(hyps, refs)
        self.eval = {
            "Bleu_1": bleu_scores[0],
            "Bleu_2": bleu_scores[1],
            "Bleu_3": bleu_scores[2],
            "Bleu_4": bleu_scores[3],
            "METEOR": meteor(hyps, refs),
            "ROUGE_L": rouge_l(hyps, refs),
            "CIDEr": cider_corpus,
        }
        self.imgToEval = {i: {"CIDEr": v} for i, v in cider_per_img.items()}


class MetricEval:
    """Reference-parity facade (``dataset.py:260-324``)."""

    def __init__(self, dataDir: str, dataType: str):
        self.dataDir = dataDir
        self.dataType = dataType
        annFile = f"{dataDir}/annotations/captions_{dataType}.json"
        self.coco = COCO(annFile)
        self.eval: dict[str, float] = {}
        self._res_cache: tuple | None = None  # (path, mtime_ns, size, cocoRes)

    def _load_res(self, resFile):
        """loadRes with a one-entry cache keyed on (path, mtime, size):
        show_results.py's per-image browse loop would otherwise re-parse the
        whole result JSON once PER IMAGE; the stat key keeps a re-written
        result file (train.py overwrites it every eval) from being served
        stale."""
        import os

        path = os.path.abspath(str(resFile))
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size)
        if self._res_cache is None or self._res_cache[:3] != key:
            self._res_cache = (*key, self.coco.loadRes(resFile))
        return self._res_cache[3]

    def __call__(self, resFile) -> float:
        cocoRes = self._load_res(resFile)
        cocoEval = COCOEvalCap(self.coco, cocoRes)
        cocoEval.params["image_id"] = cocoRes.getImgIds()
        cocoEval.evaluate()
        self.eval = cocoEval.eval
        return cocoEval.eval["CIDEr"]

    def print_result(self, imgId: int, resFile, show_image: bool = True) -> None:
        """GT vs generated captions, plus the image itself (reference
        ``dataset.py:300-324`` renders it with plt.imshow/plt.show). With a
        non-interactive matplotlib backend (Agg) the figure is saved next to
        the result file instead of shown; without matplotlib it is skipped."""
        cocoRes = self._load_res(resFile)
        print("ground truth captions")
        self.coco.showAnns(self.coco.loadAnns(self.coco.getAnnIds(imgIds=imgId)))
        print("\ngenerated caption")
        self.coco.showAnns(cocoRes.loadAnns(cocoRes.getAnnIds(imgIds=imgId)))
        if show_image:
            self._show_image(imgId, resFile)

    def _show_image(self, imgId: int, resFile) -> None:
        try:
            import matplotlib
            import matplotlib.pyplot as plt
            from PIL import Image
        except ImportError:  # image display is an optional capability
            return
        img = self.coco.loadImgs(imgId)[0]
        path = f"{self.dataDir}/images/{self.dataType}/{img['file_name']}"
        try:
            data = Image.open(path)
        except OSError:
            print(f"(image not found: {path})")
            return
        plt.imshow(data)
        plt.axis("off")
        if matplotlib.get_backend().lower().startswith("agg"):
            import os

            out = os.path.join(
                os.path.dirname(os.path.abspath(str(resFile))), f"img_{imgId}.png"
            )
            plt.savefig(out, bbox_inches="tight")
            print(f"(non-interactive backend: image saved to {out})")
        else:
            plt.show()
        plt.close()
