"""The serving artifact on the CUDA card: a small float32 model (256²,
mobilenet224_0.35, d 32, 2+2 layers, beam 2) exported on the card, loaded,
and run against its pipeline: beam search bitwise equal with each decode
kernel launched ``max_len`` × chunks × its launches a step, the fused
backbone's artifact with ``fused_ir_block`` at 17 launches a chunk, both
sampling programs on a full chunk, and an artifact of the card refused on
the CPU. Needs a CUDA card: every test here skips without one. On the card
(no JAX there, so the JAX-side conftest is skipped):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda_export.py
"""

import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_torch import export as ex
from fpn_mt_image_captioning_torch.config import Config
from fpn_mt_image_captioning_torch.data.tokenizer import REFERENCE_FILTERS, Tokenizer
from fpn_mt_image_captioning_torch.ops import fused_backbone as fb
from fpn_mt_image_captioning_torch.ops import fused_decoder as fd
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

pytestmark = pytest.mark.cuda
MAX_LEN, BEAM, BATCH, LAYERS = 8, 2, 2, 2
CFG = Config(image_input_size=256, backbone="mobilenet224_0.35", d_model=32,
             num_layers=LAYERS, num_heads=4, dff=64, compute_dtype="float32",
             beam_search_n=BEAM, decode_batch=BATCH, max_decode_rows=BATCH * BEAM)
PER_STEP = {fd.decoder_linear: 6 * LAYERS + 1, fd.decoder_add_layernorm: 3 * LAYERS,
            fd.decoder_self_attention: LAYERS, fd.decoder_cross_attention: LAYERS,
            fd.decoder_logsoftmax_topk: 1}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def tokenizer():
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(20)]
    tok = Tokenizer(num_words=CFG.top_k, oov_token="unk", filters=REFERENCE_FILTERS)
    tok.fit_on_texts(["<start> " + " ".join(rng.choice(words, 4)) + " <end>"
                      for _ in range(20)])
    tok.add_padding_token()
    return tok


@pytest.fixture(scope="module", params=[False, True], ids=["eager_encode", "fused_backbone"])
def exported(request, dev, tmp_path_factory):
    pipe = Pipeline(tokenizer(), MAX_LEN, CFG.replace(fused_backbone=request.param), seed=0,
                    device=dev)
    out = str(tmp_path_factory.mktemp("artifact"))
    meta = ex.export_serving(pipe, out, sample=not request.param)
    return pipe, meta, ex.load_serving(out), out


def test_artifact_equals_pipeline_with_counted_launches(exported):
    pipe, meta, served, _ = exported
    images = np.random.default_rng(1).integers(0, 256, (5, 256, 256, 3), dtype=np.uint8)
    want = pipe.predict_batch(images)
    fd.reset_launch_counts()
    fb.reset_launch_counts()
    got = served.predict_batch(images)
    chunks = 3
    for k, n in PER_STEP.items():
        assert k.launches == MAX_LEN * chunks * n, k.__name__
    assert fb.fused_ir_block.launches == (17 * chunks if meta["fused_backbone"] else 0)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert served.device.type == "cuda" and meta["platforms"] == ["cuda"]


def test_sampling_programs_equal_pipeline(exported):
    pipe, meta, served, _ = exported
    if not meta["sampling"]:
        pytest.skip("this artifact was exported without sampling programs")
    images = np.random.default_rng(2).integers(0, 256, (BATCH, 256, 256, 3), dtype=np.uint8)
    temps = np.asarray([0.6, 1.3], np.float32)
    for top_p in (None, 0.9):
        got = served.sample_batch(images, seed=4, temperature=temps, top_p=top_p)
        want = pipe.sample_batch(images, seed=4, temperature=temps, top_p=top_p)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def test_card_artifact_refused_on_the_cpu(exported):
    with pytest.raises(ValueError, match="exported for cuda"):
        ex.load_serving(exported[3], "cpu")
