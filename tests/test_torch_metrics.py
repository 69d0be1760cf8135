"""The port's caption metrics (``fpn_mt_image_captioning_torch/data/metrics``,
``utils/porter.py``, ``data/coco.py``) against the JAX package's: the same
strings and the same result file give exactly equal (``==``) values for the
PTB tokenizer, the Porter stemmer, BLEU-1..4, METEOR, ROUGE-L, CIDEr-D and
``MetricEval``."""

import importlib
import json

import numpy as np
import pytest

from fpn_mt_image_captioning_tpu.data import metrics as jx_metrics
from fpn_mt_image_captioning_tpu.utils.porter import porter_stem as jx_porter_stem
from fpn_mt_image_captioning_torch.data import metrics as pt_metrics
from fpn_mt_image_captioning_torch.utils.porter import porter_stem


def scorers(package: str):
    """The package's scorer modules by name (the package's ``meteor`` and
    ``cider_d`` attributes are functions, which hide the modules)."""
    return {name: importlib.import_module(f"{package}.data.metrics.{name}")
            for name in ("ptb", "bleu", "meteor", "rouge", "cider")}


PT, JX = scorers("fpn_mt_image_captioning_torch"), scorers("fpn_mt_image_captioning_tpu")

WORDS = ("the heart is normal in size lungs are clear no acute cardiopulmonary disease "
         "there pleural effusion or pneumothorax without focal consolidation stable "
         "appearance of chest running runs ran connected connection relational "
         "hopefulness generalizations Heart LUNGS clear. size, effusions").split()
STEM_WORDS = WORDS + ["caresses", "ponies", "ties", "cats", "feed", "agreed", "plastered",
                      "motoring", "sing", "conflated", "troubled", "sized", "hopping",
                      "tanned", "falling", "hissing", "fizzed", "failing", "filing",
                      "happy", "sky", "relational", "conditional", "rational", "valenci",
                      "digitizer", "operator", "feudalism", "decisiveness", "formaliti",
                      "triplicate", "formative", "electriciti", "revival", "allowance",
                      "inference", "airliner", "adjustable", "defensible", "irritant",
                      "replacement", "adoption", "homologou", "communism", "activate",
                      "angulariti", "effective", "bowdlerize", "probate", "rate",
                      "cease", "controll", "roll", "a", "is", "", "yyy", "bee"]


def corpus(seed: int, n_img: int = 12):
    """Ground truths (1-4 captions an image) and one hypothesis an image,
    drawn from a shared pool with punctuation and case, so every metric has
    matches, partial matches and misses."""
    rng = np.random.default_rng(seed)

    def caption():
        words = list(rng.choice(WORDS, rng.integers(1, 12)))
        if rng.random() < 0.5:
            words[-1] += rng.choice([" .", ".", " ,", "!"])
        return " ".join(words)

    gts = {i: [caption() for _ in range(rng.integers(1, 5))] for i in range(n_img)}
    res = {i: [gts[i][0] if rng.random() < 0.2 else caption()] for i in range(n_img)}
    return gts, res


def test_porter_stem_equal():
    assert [porter_stem(w) for w in STEM_WORDS] == [jx_porter_stem(w) for w in STEM_WORDS]


@pytest.mark.parametrize("seed", range(4))
def test_scorers_equal(seed):
    gts, res = corpus(seed)
    for caps in [*gts.values(), *res.values()]:
        for c in caps:
            assert PT["ptb"].ptb_tokenize(c) == JX["ptb"].ptb_tokenize(c)
    refs, hyps = PT["ptb"].tokenize_corpus(gts), PT["ptb"].tokenize_corpus(res)
    assert refs == JX["ptb"].tokenize_corpus(gts) and hyps == JX["ptb"].tokenize_corpus(res)
    bleu = PT["bleu"].corpus_bleu(hyps, refs)
    assert bleu == JX["bleu"].corpus_bleu(hyps, refs) and bleu[0] > 0
    assert PT["meteor"].meteor(hyps, refs) == JX["meteor"].meteor(hyps, refs) > 0
    assert PT["meteor"].meteor_segments_mean(hyps, refs) == \
        JX["meteor"].meteor_segments_mean(hyps, refs)
    assert PT["rouge"].rouge_l(hyps, refs) == JX["rouge"].rouge_l(hyps, refs) > 0
    got = PT["cider"].CiderScorer().compute(hyps, refs)
    assert got == JX["cider"].CiderScorer().compute(hyps, refs) and got[0] > 0
    assert PT["cider"].cider_d(hyps, refs) == JX["cider"].cider_d(hyps, refs)


def write_split(root, gts, res):
    """A COCO caption split (annotations of ``gts``) and a result file (the
    first hypothesis of each image)."""
    (root / "annotations").mkdir(parents=True)
    images = [{"id": 100 + i, "file_name": f"img_{i}.png"} for i in gts]
    anns = [{"id": 10 * i + j, "image_id": 100 + i, "caption": c}
            for i, caps in gts.items() for j, c in enumerate(caps)]
    (root / "annotations" / "captions_val2017.json").write_text(
        json.dumps({"images": images, "annotations": anns}))
    path = root / "res.json"
    path.write_text(json.dumps([{"image_id": 100 + i, "caption": caps[0]}
                                for i, caps in res.items()]))
    return str(path)


@pytest.mark.parametrize("seed", range(2))
def test_metric_eval_equal(seed, tmp_path, capsys):
    gts, res = corpus(seed + 10)
    res_file = write_split(tmp_path, gts, res)
    pt = pt_metrics.MetricEval(str(tmp_path), "val2017")
    jx = jx_metrics.MetricEval(str(tmp_path), "val2017")
    assert pt(res_file) == jx(res_file) > 0
    assert pt.eval == jx.eval
    assert list(pt.eval) == ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
                             "CIDEr"]
    for img_id in (100, 105):
        pt.print_result(img_id, res_file, show_image=False)
        got = capsys.readouterr().out
        jx.print_result(img_id, res_file, show_image=False)
        assert got == capsys.readouterr().out and "generated caption" in got
