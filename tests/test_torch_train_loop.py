"""The port's training loop against the JAX package's, on the CPU: the
training dataset (order, caption rows, tokenizer, with and without the
decoded-image cache), BatchNorm re-estimation, the smart saver's decisions,
the port's checkpoints, captioning after training steps, the ``train`` entry
point over two epochs, the dataset converter, and the options that are not
ported. Small sizes: 256² and mobilenet224_0.35 for the model, 64² images
for the data layer."""

import json
import os
import pathlib
import shutil
import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util

from fixtures import make_iuxray_raw, make_synthetic_dataset
from fpn_mt_image_captioning_tpu.config import Config as JxConfig
from fpn_mt_image_captioning_tpu.data import convert as jx_convert
from fpn_mt_image_captioning_tpu.data import dataset as jx_dataset
from fpn_mt_image_captioning_tpu.train import checkpoint as jx_checkpoint
from fpn_mt_image_captioning_tpu.train.pipeline import Pipeline as JxPipeline
from fpn_mt_image_captioning_tpu.train.pipeline import TrainState as JxTrainState
from fpn_mt_image_captioning_tpu.utils import tensorboard as jx_tensorboard
from fpn_mt_image_captioning_torch import convert_dataset as pt_convert_dataset
from fpn_mt_image_captioning_torch.config import Config
from fpn_mt_image_captioning_torch.config import MeshConfig as PtMeshConfig
from fpn_mt_image_captioning_torch.data import convert as pt_convert
from fpn_mt_image_captioning_torch.data import dataset as pt_dataset
from fpn_mt_image_captioning_torch.data.metrics import MetricEval
from fpn_mt_image_captioning_torch.train import checkpoint as pt_checkpoint
from fpn_mt_image_captioning_torch.train.__main__ import main as train_main
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from fpn_mt_image_captioning_torch.utils import tensorboard as pt_tensorboard
from fpn_mt_image_captioning_torch.weights import read_flax_msgpack, to_flax
from test_torch_slice import CFG

SIZE = 256
FIELDS = dict(image_input_size=SIZE, backbone=CFG.backbone, d_model=CFG.d_model,
              num_layers=CFG.num_layers, num_heads=CFG.num_heads, dff=CFG.dff,
              compute_dtype="float32", warm_up_steps=10, batch_size=3, beam_search_n=2,
              decode_batch=2, epochs=2, n_val_dataset=2, bn_finalize_batches=1)


def flat(tree) -> dict:
    return traverse_util.flatten_dict(jax.device_get(tree), sep="/")


def both_configs(root: pathlib.Path, datadir: str, **kw):
    fields = dict(FIELDS, datadir=datadir, tokenizer_filename=str(root / "tok.json"),
                  additional_filename=str(root / "info.json"),
                  transformer_checkpoint_path=str(root / "ckpt"),
                  transformer_weight_path=str(root / "weights.msgpack"),
                  result_dir=str(root / "results"), **kw)
    return JxConfig(**fields), Config(**fields)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A synthetic split at 256² (4 training images: a full batch of 3 and a
    tail of 1; 2 validation images), the JAX pipeline's own init on it, and
    its variables as numpy arrays."""
    root = tmp_path_factory.mktemp("train_loop")
    datadir = make_synthetic_dataset(str(root / "data"), n_train=4, n_val=2, image_size=SIZE)
    jcfg, cfg = both_configs(root / "jx", datadir)
    (root / "jx").mkdir()
    dataset, max_seq_len, _ = jx_dataset.get_coco_images_dataset(
        datadir, jcfg.datatype_train, config=jcfg)
    jpipe = JxPipeline(jcfg.tokenizer_filename, jcfg.transformer_checkpoint_path, max_seq_len,
                       jcfg)
    variables = jax.tree.map(np.asarray, jax.device_get(
        {"params": jpipe.state.params, "batch_stats": jpipe.state.batch_stats}))
    batches = [img for img, _ in dataset]
    return dict(root=root, datadir=datadir, jcfg=jcfg, cfg=cfg, jpipe=jpipe,
                max_seq_len=max_seq_len, variables=variables, batches=batches)


def training_pipeline(world, path, **kw) -> Pipeline:
    return Pipeline(world["jcfg"].tokenizer_filename, world["max_seq_len"],
                    world["cfg"].replace(**kw), world["variables"], device="cpu",
                    checkpoint_path=str(path))


# ---------------------------------------------------------------------------
# the data layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("cached", [False, True])
def test_dataset_order_and_rows_match_jax(tmp_path, cached):
    """``get_coco_images_dataset`` of both packages on one split of 7
    captions (batch 3): the same ``max_seq_len`` and ``set_len``, equal
    tokenizer files, and over two epochs the same batches in the
    same order (uint8 images and caption rows equal), with and without the
    decoded-image cache (``dataset_cache``)."""
    datadir = make_synthetic_dataset(str(tmp_path / "data"), n_train=7, n_val=1)
    out = []
    for name, mod, cls in (("jx", jx_dataset, JxConfig), ("pt", pt_dataset, Config)):
        cfg = cls(image_input_size=64, batch_size=3, buffer_size=4, seed=5,
                  tokenizer_filename=str(tmp_path / name / "tok.json"),
                  dataset_cache=str(tmp_path / name / "cache") if cached else "")
        dataset, max_seq_len, set_len = mod.get_coco_images_dataset(
            datadir, cfg.datatype_train, config=cfg)
        epochs = [[(img.copy(), cap.copy()) for img, cap in dataset] for _ in range(2)]
        out.append((max_seq_len, set_len, epochs, len(dataset)))
        assert (pathlib.Path(cfg.dataset_cache + ".bin").is_file()) == cached
    (jl, js, jepochs, jn), (pl, ps, pepochs, pn) = out
    assert (pl, ps, pn) == (jl, js, jn) == (jl, 3, 3)
    assert (tmp_path / "pt" / "tok.json").read_bytes() == (tmp_path / "jx" / "tok.json").read_bytes()
    assert [len(e) for e in pepochs] == [3, 3]
    for je, pe in zip(jepochs, pepochs):
        for (jimg, jcap), (pimg, pcap) in zip(je, pe):
            assert pimg.dtype == jimg.dtype == np.uint8
            np.testing.assert_array_equal(pimg, jimg)
            np.testing.assert_array_equal(pcap, jcap)
    # the two epochs visit the captions in different orders
    assert not all(np.array_equal(a[1], b[1]) for a, b in zip(pepochs[0], pepochs[1]))


def test_converter_matches_jax(tmp_path):
    """The port's converter against the JAX package's on the same raw IU
    X-ray reports (seeded split): the same annotation bytes and the same
    copied images; the module entry point converts too."""
    xml_dir, image_root = make_iuxray_raw(str(tmp_path / "raw"), n_reports=5)
    for name, mod, cls in (("jx", jx_convert, JxConfig), ("pt", pt_convert, Config)):
        mod.convert_store_to_coco_val_train(xml_dir, image_root, 2,
                                            cls(datadir=str(tmp_path / name)), seed=3)
    for split in ("val2017", "train2017"):
        ann = f"annotations/captions_{split}.json"
        assert (tmp_path / "pt" / ann).read_bytes() == (tmp_path / "jx" / ann).read_bytes()
        assert sorted(os.listdir(tmp_path / "pt" / "images" / split)) == \
            sorted(os.listdir(tmp_path / "jx" / "images" / split))
    pt_convert_dataset.main([f"--xml_dir={xml_dir}", f"--image_dir={image_root}",
                             "--amount_of_validation=2", f"--datadir={tmp_path / 'cli'}"])
    n = sum(len(json.loads((tmp_path / "cli" / "annotations" / f"captions_{s}.json")
                           .read_text())["annotations"]) for s in ("val2017", "train2017"))
    assert n == 10


# ---------------------------------------------------------------------------
# BatchNorm re-estimation, checkpoints, the smart saver
# ---------------------------------------------------------------------------
def test_finalize_batch_stats_matches_jax(world, tmp_path):
    """BN re-estimation over the training batches (a batch of 3 and a tail
    of 1: re-chunked to one chunk of 3, the row left over unused) against
    the JAX pipeline's, from the same weights: every statistic rtol 5e-5,
    atol 1e-5, and the count of chunks equal. The moments of a layer come
    from a float32 forward through every training-mode block before it, and
    the two packages' roundings drift apart with depth: the variances agree
    to 2e-6 in the stem and 2.8e-5 in the head; the channel means of
    activations that BatchNorm has just centred are rounding, ~1e-6 on a
    scale of 1."""
    jpipe = world["jpipe"]
    saved = jpipe.state
    try:
        want_n = jpipe.finalize_batch_stats(iter(world["batches"]))
        want = flat(jpipe.state.batch_stats)
    finally:
        jpipe.state = saved
    pipe = training_pipeline(world, tmp_path / "ckpt")
    assert pipe.finalize_batch_stats(iter(world["batches"])) == want_n == 1
    got = flat(to_flax(pipe.state.model)["batch_stats"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=5e-5, atol=1e-5, err_msg=k)
    assert not np.allclose(got[k], flat(world["variables"]["batch_stats"])[k])


class _Recorder:
    directory = "recorder"

    def __init__(self):
        self.saved = []

    def save(self, step, state):
        self.saved.append((step, state))


@pytest.mark.parametrize("epochs,ciders", [
    (10, [0.1, 0.2, 0.15, 0.3, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1]),
    (10, [0.5, 0.4, 0.3, 0.2, 0.1, 0.6, 0.2, 0.2, 0.2, 0.2]),
    (6, [0.3, 0.3, 0.3, 0.3, 0.3, 0.3]),
    (8, [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8]),
    (40, [0.5, 0.1, 0.2, 0.1] + [0.05] * 36),
])
def test_smart_saver_makes_jax_decisions(epochs, ciders):
    """Scripted CIDEr sequences through both packages' ``SmartCheckpointSaver``
    (gap 3): the same decision each epoch, the same saves, ``max_acc_epoch``
    and ``best_saved_step``; a callable state is made only when saved."""
    jrec, prec = _Recorder(), _Recorder()
    jsaver = jx_checkpoint.SmartCheckpointSaver(jrec, epochs=epochs, gap_of_dead_epoch=3)
    psaver = pt_checkpoint.SmartCheckpointSaver(prec, epochs=epochs, gap_of_dead_epoch=3)
    made = []
    for epoch, cider in enumerate(ciders, start=1):
        want = jsaver(epoch, cider, f"state{epoch}")
        got = psaver(epoch, cider, lambda e=epoch: made.append(e) or f"state{e}")
        assert got == want, epoch
        assert (psaver.max_val_acc, psaver.max_acc_epoch, psaver.best_saved_step) == \
            (jsaver.max_val_acc, jsaver.max_acc_epoch, jsaver.best_saved_step)
        if want == -1:
            break
    assert prec.saved == jrec.saved
    assert made == [step for step, _ in jrec.saved]


def test_checkpoint_manager_round_trip_pruning_and_shim(world, tmp_path, capsys):
    """A training pipeline's state tree saved and restored bitwise; the file
    restores into the JAX ``TrainState`` layout; ``max_to_keep`` prunes the
    oldest steps; an older optimizer format restores the weights and
    re-initializes ``opt_state`` loudly; a params mismatch raises."""
    pipe = training_pipeline(world, tmp_path / "ckpt")
    pipe.train_step(world["batches"][0], np.ones((3, world["max_seq_len"]), np.int32))
    tree = pipe.state_tree()
    mgr = pt_checkpoint.CheckpointManager(str(tmp_path / "m"), max_to_keep=2)
    for step in (1, 2, 3):
        mgr.save(step, tree)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step == 3
    assert not (tmp_path / "m" / "1").exists()
    restored = mgr.restore(tree)
    assert flat(restored).keys() == flat(tree).keys()
    for k, v in flat(tree).items():
        r = flat(restored)[k]
        assert r.dtype == v.dtype and r.shape == v.shape and r.tobytes() == v.tobytes(), k
    jstate = serialization.from_state_dict(world["jpipe"].state, serialization.msgpack_restore(
        (tmp_path / "m" / "3" / pt_checkpoint.STATE_FILE).read_bytes()))
    assert isinstance(jstate, JxTrainState) and int(jstate.step) == 1
    assert int(jstate.opt_state[1].count) == 1

    # the restored tree becomes the state of a new pipeline
    again = training_pipeline(world, tmp_path / "m")
    assert "Latest checkpoint restored" in capsys.readouterr().out
    for k, v in flat(again.state_tree()).items():
        assert v.tobytes() == flat(tree)[k].tobytes(), k

    old = dict(tree, opt_state={"0": {}, "1": {"count": tree["opt_state"]["1"]["count"],
                                             "mu": tree["opt_state"]["1"]["m"]}})
    mgr.save(4, old)
    fresh = training_pipeline(world, tmp_path / "fresh").state_tree()
    shimmed = mgr.restore(fresh, step=4)
    assert "REINITIALIZED opt_state" in capsys.readouterr().out
    assert shimmed["opt_state"] is fresh["opt_state"]
    assert flat(shimmed["params"]).keys() == flat(tree["params"]).keys()
    bad = dict(tree, params={**tree["params"], "extra": np.zeros(3, np.float32)})
    mgr.save(5, bad)
    with pytest.raises(ValueError, match="structure does not match"):
        mgr.restore(fresh, step=5)


def orbax_checkpoint(path) -> None:
    """A JAX-package (Orbax) checkpoint of a small train state."""
    params = {"w": jnp.ones((2, 3))}
    mgr = jx_checkpoint.CheckpointManager(str(path))
    mgr.save(1, JxTrainState(params, {}, {"count": jnp.int32(0)}, jnp.int32(0)))
    mgr.close()


def test_orbax_directory_raises(tmp_path):
    orbax_checkpoint(tmp_path / "orbax")
    with pytest.raises(NotImplementedError, match="Orbax.*A.2"):
        pt_checkpoint.CheckpointManager(str(tmp_path / "orbax"))


# ---------------------------------------------------------------------------
# captioning after training; the entry point
# ---------------------------------------------------------------------------
def test_predict_after_training_serves_the_current_weights(world, tmp_path):
    """After k train steps (dropout 0.1), ``predict_batch`` equals that of a
    fresh pipeline built from the trained float32 weights; the master copy
    stays float32 and untouched by the serving cast; ``save_weights`` of a
    bf16 training pipeline writes the float32 master weights."""
    images = world["batches"][0]
    caps = np.ones((3, world["max_seq_len"]), np.int32)
    for dtype in ("float32", "bfloat16"):
        pipe = training_pipeline(world, tmp_path / dtype, compute_dtype=dtype)
        before = pipe.predict_batch(images)
        served_before = pipe.transformer
        assert pipe.state.model.decoder.embedding.weight.dtype == torch.float32
        for _ in range(3):
            pipe.train_step(images, caps)
        got = pipe.predict_batch(images)
        assert pipe.transformer is not served_before
        trained = to_flax(pipe.state.model)
        fresh = Pipeline(world["jcfg"].tokenizer_filename, world["max_seq_len"],
                         world["cfg"].replace(compute_dtype=dtype), trained, device="cpu")
        want = fresh.predict_batch(images)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert all(t.dtype == torch.float32 for t in pipe.state.model.state_dict().values())
        pipe.save_weights(str(tmp_path / f"{dtype}.msgpack"))
        saved = flat(read_flax_msgpack(str(tmp_path / f"{dtype}.msgpack")))
        for k, v in flat(trained).items():
            assert saved[k].dtype == np.float32 and saved[k].tobytes() == v.tobytes(), k
        assert any(not np.array_equal(a, b) for a, b in zip(before, got)) or dtype == "float32"


def read_events(path) -> list[bytes]:
    """The payloads of a TFRecord file, each CRC checked with the JAX
    writer's masked CRC32C."""
    data, out, i = pathlib.Path(path).read_bytes(), [], 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == jx_tensorboard._masked_crc(header)
        payload = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == \
            jx_tensorboard._masked_crc(payload)
        out.append(payload)
        i += 16 + n
    return out


def test_train_main_two_epochs(world, tmp_path, monkeypatch, capsys):
    """``python -m fpn_mt_image_captioning_torch.train``'s ``main`` on the
    CPU over two epochs of the synthetic split (the tail batch padded to 3):
    CIDEr scripted (0.1, then 0.2) around the real ``MetricEval``, so epoch 2
    saves; the sidecar holds ``max_seq_len`` and the best epoch, the
    checkpoint of step 2 restores, ``scalars.jsonl`` holds loss and CIDEr of
    both epochs, the event file is the one the JAX writer writes for those
    scalars (same clock), and the final msgpack file loads in the JAX
    ``Pipeline.load_weights`` to the trained weights."""
    monkeypatch.chdir(tmp_path)
    _, cfg = both_configs(tmp_path, world["datadir"])
    scripted = iter([0.1, 0.2])
    real = MetricEval.__call__
    monkeypatch.setattr(MetricEval, "__call__",
                        lambda self, path: real(self, path) * 0 + next(scripted))
    clock = types.SimpleNamespace(time=lambda: 1.7e9)
    monkeypatch.setattr(pt_tensorboard, "time", clock)
    padded = []
    real_step = Pipeline.train_step
    monkeypatch.setattr(Pipeline, "train_step", lambda self, img, cap: padded.append(
        (len(img), int((np.asarray(cap) != 0).any(1).sum()))) or real_step(self, img, cap))
    pipe = train_main(cfg, device="cpu")
    out = capsys.readouterr().out
    assert padded == [(3, 3), (3, 1)] * 2
    assert "BN stats finalized over 1 train batches" in out
    assert out.count("Evaluating...") == 2 and "Saving checkpoint for epoch 2" in out
    info = json.loads(pathlib.Path(cfg.additional_filename).read_text())
    assert info == {"max_seq_len": world["max_seq_len"], "mt_epoch_ckpt": 2}
    assert pipe.ckpt_manager.all_steps() == [2] and pipe.smart_ckpt_saver.best_saved_step == 2
    assert len(json.loads(pathlib.Path(cfg.result_file).read_text())) == 2

    [log_dir] = list((tmp_path / "logs" / "transformer").iterdir())
    rows = [json.loads(line) for line in (log_dir / "train" / "scalars.jsonl").open()]
    assert [(r["tag"], r["step"]) for r in rows] == [("loss", 0), ("CIDEr", 0), ("loss", 1),
                                                     ("CIDEr", 1)]
    assert [r["value"] for r in rows if r["tag"] == "CIDEr"] == [0.1, 0.2]
    [event] = list((log_dir / "train").glob("events.out.tfevents.*"))
    monkeypatch.setattr(jx_tensorboard, "time", clock)
    jx_writer = jx_tensorboard.SummaryWriter(str(tmp_path / "jx_events"))
    for r in rows:
        jx_writer.scalar(r["tag"], r["value"], r["step"])
    jx_writer.close()
    [jx_event] = list((tmp_path / "jx_events").iterdir())
    assert event.name == jx_event.name
    assert read_events(event) == read_events(jx_event)
    assert event.read_bytes() == jx_event.read_bytes()

    jpipe = world["jpipe"]
    saved = jpipe.state
    try:
        jpipe.load_weights(cfg.transformer_weight_path)
        got = flat({"params": jpipe.state.params, "batch_stats": jpipe.state.batch_stats})
    finally:
        jpipe.state = saved
    want = flat(to_flax(pipe.state.model))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.asarray(got[k]).tobytes() == v.tobytes(), k


UNPORTED = {
    "mesh": dict(mesh=PtMeshConfig(enabled=True, model_axis_size=2)),
    "retinanet_weight_path": dict(retinanet_weight_path="retinanet.h5"),
    "orbax": {},
}


@pytest.mark.parametrize("option", list(UNPORTED))
def test_unported_options_raise_before_the_first_step(world, tmp_path, monkeypatch, option):
    """Each option the port cannot honour raises before any train step runs:
    a checkpoint directory of Orbax checkpoints (A.2) ``NotImplementedError``,
    and a mesh that the world of ranks cannot form (here 1 × 2 in a world of
    one process; the mesh itself is ported: tests/test_torch_parallel*.py)
    ``ValueError``. The Keras ``.h5`` boot is ported: a
    ``retinanet_weight_path`` with no file there raises ``OSError`` before
    the first step, as the JAX package's h5py does (the boot from a file:
    tests/test_torch_hdf5.py). The serving export and the step tracer are
    ported (tests/test_torch_train_options.py)."""
    monkeypatch.chdir(tmp_path)
    _, cfg = both_configs(tmp_path, world["datadir"])
    kw = UNPORTED[option]
    if option == "orbax":
        orbax_checkpoint(tmp_path / "ckpt")
    steps = []
    monkeypatch.setattr(Pipeline, "train_step", lambda *a: steps.append(a))
    if option == "retinanet_weight_path":
        raised = pytest.raises(OSError)
    elif option == "mesh":
        raised = pytest.raises(ValueError, match=r"mesh 0x2 != 1 ranks")
    else:
        raised = pytest.raises(NotImplementedError, match="A.2")
    with raised:
        train_main(cfg.replace(**kw), device="cpu")
    assert steps == []
    shutil.rmtree(tmp_path / "ckpt", ignore_errors=True)
