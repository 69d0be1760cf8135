"""The port's evaluation surface against the JAX package's on the CPU, on one
trained model: the slice's perturbed variables (``tests/test_torch_slice.py``)
saved by the JAX package as an Orbax checkpoint (what root ``test.py`` and
``train.py`` restore) and as the Flax msgpack file (what the port reads with
``transformer_weight_path``), over a synthetic validation split of five images.

``Pipeline.evaluate`` in its batched leg (uint8 batches of two, the padded
tail dropped) and its one-at-a-time leg, ``evaluate_img`` and the port's
``test.py``, ``evaluate.py`` and ``show_results.py`` give what the JAX
package gives: equal result lists and files, equal printouts. JAX runs its
CPU (non-fused) route; the beam margin on these images is checked as in
``test_predict_batch_matches_jax``."""

import importlib.util
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_tpu.data.dataset import COCO_Images_ImageID as JxImageIDs
from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
from fpn_mt_image_captioning_torch import evaluate as pt_evaluate
from fpn_mt_image_captioning_torch import show_results as pt_show_results
from fpn_mt_image_captioning_torch import test as pt_test
from fpn_mt_image_captioning_torch.data.dataset import COCO_Images_ImageID, load_image
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from test_torch_slice import jax_beam_margins
from test_torch_weight_files import N_VAL, jax_world

REPO = pathlib.Path(__file__).resolve().parents[1]


def root_script(name: str):
    """A root entry point of the JAX package, loaded by its path (the name
    ``test`` would find the standard library's package)."""
    spec = importlib.util.spec_from_file_location(f"root_{name}", REPO / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = jax_world(tmp_path_factory.mktemp("evaluate"), checkpoint=True)
    w["pipe"] = Pipeline.from_config(w["cfg"], device="cpu")
    return w


def val_split(world, cls):
    cfg = world["cfg"]
    return cls(cfg.datadir, cfg.datatype_val, N_VAL, image_size=cfg.image_input_size,
               seed=cfg.seed)


@pytest.mark.parametrize("leg", ["batched", "one_at_a_time"])
def test_evaluate_matches_jax(world, leg):
    """The port's ``evaluate`` against the JAX ``Pipeline.evaluate`` on the
    same msgpack weights: equal result lists, captions that differ by image."""
    pt_val, jx_val = val_split(world, COCO_Images_ImageID), val_split(world, JxImageIDs)
    if leg == "one_at_a_time":   # a plain iterable of (img, imgId): no iter_batches
        pt_val, jx_val = list(pt_val), list(jx_val)
    got = world["pipe"].evaluate(pt_val)
    want = world["jpipe"].evaluate(jx_val)
    assert got == want
    assert [r["image_id"] for r in got] == val_split(world, COCO_Images_ImageID).imgIds
    assert len(got) == N_VAL and len({r["caption"] for r in got}) > 1   # not vacuous


def test_beam_margin_on_the_split(world):
    """No near tie in JAX's search over these images, so equal captions are
    the evidence, not luck."""
    imgs, _, valid = next(val_split(world, JxImageIDs).iter_batches(N_VAL, as_uint8=True))
    assert valid == N_VAL
    jx, variables, jtok = world["jx"], world["variables"], world["jtok"]
    enc = jax.jit(lambda v, x: jx.apply(v, x, train=False, method=JxTransformer.encode))(
        variables, imgs)
    assert jax_beam_margins(jx, variables, enc, jtok.word_index["<start>"],
                            jtok.word_index["<end>"]) > 1e-3


def test_evaluate_img_and_test_py_match_root(world, capsys):
    """``evaluate_img`` and the port's ``test.py`` against root ``test.py``,
    which restores the Orbax checkpoint of the same weights."""
    img = sorted((pathlib.Path(world["cfg"].datadir) / "images" / "val2017").glob("*.png"))[2]
    jcfg = world["jcfg"].replace(result_dir=str(world["root"] / "root_test"))
    want = root_script("test").main(jcfg, str(img))
    want_out = capsys.readouterr().out.splitlines()
    cfg = world["cfg"].replace(result_dir=str(world["root"] / "port_test"))
    got = pt_test.main(cfg, str(img), device="cpu")
    got_out = capsys.readouterr().out.splitlines()
    assert got == want
    name = f"{img.stem}_captions_result.json"
    assert json.loads((world["root"] / "port_test" / name).read_text()) == \
        json.loads((world["root"] / "root_test" / name).read_text())
    assert got_out == want_out[want_out.index("Evaluating..."):]
    pixels = load_image(str(img), None, cfg.image_input_size)[0]
    assert world["pipe"].evaluate_img(pixels) == want


def test_evaluate_py_and_show_results_match_root(world, capsys):
    """The port's ``evaluate.py`` against root ``train.py --is_training=false``:
    the same result file and the same printout from "Evaluating..." on (the
    metric table); then the port's ``show_results.py`` against root
    ``show_results.py`` over that file."""
    jcfg = world["jcfg"].replace(is_training=False, result_dir=str(world["root"] / "root_eval"))
    root_script("train").main(jcfg)
    want_out = capsys.readouterr().out.splitlines()
    cfg = world["cfg"].replace(is_training=False, result_dir=str(world["root"] / "port_eval"))
    results = pt_evaluate.main(cfg, device="cpu")
    got_out = capsys.readouterr().out.splitlines()
    want = json.loads(pathlib.Path(jcfg.result_file).read_text())
    assert json.loads(pathlib.Path(cfg.result_file).read_text()) == want == results
    assert got_out == want_out[want_out.index("Evaluating..."):]
    assert [line.split(":")[0] for line in got_out[1:]] == [
        "Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr"]

    root_script("show_results").main(jcfg)
    want_show = capsys.readouterr().out
    pt_show_results.main(cfg.replace(result_dir=jcfg.result_dir))
    assert capsys.readouterr().out == want_show
    assert want_show.count("generated caption") == N_VAL

    with pytest.raises(NotImplementedError, match="fpn_mt_image_captioning_torch.train"):
        pt_evaluate.main(cfg.replace(is_training=True), device="cpu")


def test_metric_eval_matches_jax_on_the_result_file(world, tmp_path):
    results = world["pipe"].evaluate(val_split(world, COCO_Images_ImageID))
    path = tmp_path / "res.json"
    path.write_text(json.dumps(results))
    assert world["pipe"].metric_eval(str(path)) == world["jpipe"].metric_eval(str(path))
    assert world["pipe"].metric_eval.eval == world["jpipe"].metric_eval.eval


def test_from_config_refuses_orbax_without_weights(world):
    """An Orbax checkpoint and no msgpack file at ``transformer_weight_path``:
    ``from_config`` restores the checkpoint's weights, as the JAX
    ``Pipeline`` restores them, never the seeded init in their place; the
    port's ``test.py`` captions with them as from the msgpack file."""
    assert any(pathlib.Path(world["cfg"].transformer_checkpoint_path).iterdir())
    cfg = world["cfg"].replace(transformer_weight_path=str(world["root"] / "none.msgpack"),
                               result_dir=str(world["root"] / "orbax_test"))
    pipe = Pipeline.from_config(cfg, device="cpu")
    got, want = pipe.transformer.state_dict(), world["pipe"].transformer.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    img = sorted((pathlib.Path(cfg.datadir) / "images" / "val2017").glob("*.png"))[0]
    pixels = load_image(str(img), None, cfg.image_input_size)[0]
    assert pt_test.main(cfg, str(img), device="cpu") == world["pipe"].evaluate_img(pixels)


def test_metric_eval_is_built_on_first_use(world, monkeypatch):
    """A pipeline starts without a dataset; ``metric_eval`` reads it only
    when asked; evaluating across processes needs a batched iterator (each
    rank's shard decodes in lock step: tests/test_torch_parallel_world.py)."""
    cfg = world["cfg"].replace(datadir=str(world["root"] / "no_such_dir"))
    pipe = Pipeline(cfg.tokenizer_filename, 8, cfg, seed=1, device="cpu")
    with pytest.raises(FileNotFoundError):
        pipe.metric_eval
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="several ranks needs a batched iterator"):
        pipe.evaluate([])
    monkeypatch.undo()   # in one process again (several ranks without a mesh refuse to decode)
    assert np.asarray(pipe.predict_batch(world["images"][:1])[0]).shape == (1, 8)


def test_captions_generator_and_additional_info_match_jax(world, tmp_path):
    """``get_coco_images_captions_generator`` yields what the JAX package's
    yields (images bitwise, tokenized captions), and each package reads the
    other's additional-info sidecar."""
    from fpn_mt_image_captioning_tpu.data import dataset as jx_dataset
    from fpn_mt_image_captioning_torch.data import dataset as pt_dataset

    cfg, jcfg = world["cfg"], world["jcfg"]
    got = list(pt_dataset.get_coco_images_captions_generator(cfg.datadir, cfg.datatype_val, cfg))
    want = list(jx_dataset.get_coco_images_captions_generator(jcfg.datadir, jcfg.datatype_val,
                                                              jcfg))
    assert len(got) == len(want) == N_VAL
    for (img, caps), (jimg, jcaps) in zip(got, want):
        assert img.dtype == jimg.dtype and img.tobytes() == jimg.tobytes() and caps == jcaps
    info = {"max_seq_len": 11, "mt_epoch_x": 3}
    pt_dataset.store_additional_info(info, str(tmp_path / "a" / "pt.json"))
    jx_dataset.store_additional_info(info, str(tmp_path / "jx.json"))
    assert jx_dataset.load_additional_info(str(tmp_path / "a" / "pt.json")) == info
    assert pt_dataset.load_additional_info(str(tmp_path / "jx.json")) == info
    with pytest.raises(FileNotFoundError, match="tokenizer"):
        next(pt_dataset.get_coco_images_captions_generator(
            cfg.datadir, cfg.datatype_val, cfg.replace(tokenizer_filename=str(tmp_path / "no"))))
