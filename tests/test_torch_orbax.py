"""The port's Orbax reader (``train/orbax_store.py``) and its use
(``train/checkpoint.py``, ``Pipeline.from_config``, the ``train`` main)
against the JAX package on the CPU. Checkpoints are written here by the JAX
package's ``CheckpointManager`` (orbax, tensorstore and zstandard are
present in this environment, and imported by this test only) and by
tensorstore's OCDBT and zarr drivers directly, for what Orbax's defaults do
not reach (interior B-tree nodes, values outside the nodes, no compression,
chunked arrays, chunks never stored). The reader gives back each leaf
bitwise; an encoding it does not cover raises naming it.

The JAX ``TrainState`` of a small model (128², mobilenet224_0.35, d 32, 2+2
layers, dropout 0) after 2 steps, saved by the JAX manager: the port's
restore equals JAX's own restore leaf by leaf, ``Pipeline.from_config``
captions as the JAX pipeline restored from it, the port's ``train`` main
resumes from it and takes one step whose loss is JAX's next step's within
the train-step tests' bar for a third step (rtol 1e-3); an ``opt_state`` of
another structure is re-initialised with the warning, any other mismatch
raises."""

import json
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
from flax import serialization, traverse_util

from fixtures import make_synthetic_dataset
from fpn_mt_image_captioning_torch.config import Config
from fpn_mt_image_captioning_torch.train import checkpoint as pt_checkpoint
from fpn_mt_image_captioning_torch.train import orbax_store
from fpn_mt_image_captioning_torch.train.__main__ import main as train_main
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from fpn_mt_image_captioning_tpu.config import Config as JxConfig
from fpn_mt_image_captioning_tpu.data import dataset as jx_dataset
from fpn_mt_image_captioning_tpu.train import checkpoint as jx_checkpoint
from fpn_mt_image_captioning_tpu.train.pipeline import Pipeline as JxPipeline
from fpn_mt_image_captioning_tpu.train.pipeline import TrainState as JxTrainState
from test_torch_backbones import one_torch_thread  # noqa: F401 (fixture)
from test_torch_slice import CFG

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def toy_tree(seed: int) -> dict:
    """float32, bfloat16, int32, float16 and int64 leaves, a 0-d one, one
    equal to the fill value (all zeros) and an empty dict."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": jnp.asarray(rng.standard_normal(5), jnp.bfloat16),
                  "d": np.arange(6, dtype=np.int32).reshape(2, 3),
                  "h": rng.standard_normal((2, 2)).astype(np.float16),
                  "l": np.array([-(2 ** 40), 7], np.int64)},
            "s": np.array(2.5, np.float32), "z": np.zeros((4,), np.float32), "e": {}}


def assert_leaves_bitwise(got, want, path="") -> int:
    """``got`` (the port's: numpy, ``BFloat16Bits`` or torch bfloat16) equal
    to ``want`` (JAX's restore) leaf by leaf; returns the leaves compared."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        return sum(assert_leaves_bitwise(got[k], want[k], f"{path}/{k}") for k in want)
    want = np.asarray(want)
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16", path
        got = got.view(torch.int16).numpy()
    elif isinstance(got, orbax_store.BFloat16Bits):
        assert str(want.dtype) == "bfloat16", path
    else:
        assert got.dtype == want.dtype, path
    assert got.shape == want.shape and got.tobytes() == want.tobytes(), path
    return 1


@pytest.mark.parametrize("steps", [1, 3])
def test_toy_tree_reads_as_orbax_restores_it(tmp_path, steps):
    """A step written by the JAX manager (over several saves, each step its
    own store) read by the port's reader: every leaf as Orbax restores it."""
    mgr = jx_checkpoint.CheckpointManager(str(tmp_path))
    for step in range(1, steps + 1):
        mgr.save(step, toy_tree(step))
    want = mgr.restore(toy_tree(0), step=steps)
    mgr.close()
    got = orbax_store.read_step(tmp_path / str(steps))
    assert isinstance(got["b"]["c"], orbax_store.BFloat16Bits)
    assert got["e"] == {} and assert_leaves_bitwise(got, want) == 7
    mine = pt_checkpoint.CheckpointManager(str(tmp_path))
    assert mine.all_steps() == list(range(1, steps + 1))
    assert isinstance(mine.read(steps)["b"]["c"], torch.Tensor)   # bfloat16 as torch's


def _ocdbt(path, **config):
    return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                            "config": config}).result()


KV_CASES = {
    # a node limit small enough for interior nodes, values outside the nodes
    "interior_nodes": dict(max_decoded_node_bytes=600, max_inline_value_bytes=16,
                           version_tree_arity_log2=2),
    "uncompressed": dict(compression=None),
    "zstd_level_5": dict(compression={"id": "zstd", "level": 5}),
}


@pytest.mark.parametrize("case", list(KV_CASES))
def test_database_reads_what_tensorstore_wrote(tmp_path, case):
    """Keys of shared prefixes over many commits (a history of versions):
    the latest version's keys and values, as tensorstore lists and reads
    them."""
    kv = _ocdbt(tmp_path, **KV_CASES[case])
    rng = np.random.default_rng(0)
    for i in range(40):
        kv[f"layer_{i % 13:02d}/{i:04d}"] = rng.bytes(int(rng.integers(0, 90)))
    kv["layer_00/0000"] = b"rewritten"
    del kv["layer_01/0001"]
    db = orbax_store.Database(str(tmp_path))
    keys = kv.list().result()
    assert sorted(db.values) == sorted(keys) and len(keys) == 39
    assert all(db.get(k) == kv[k] for k in keys)
    assert db.get("layer_01/0001") is None and db.get("layer_00/0000") == b"rewritten"


def test_zarr_chunks_and_fill_value(tmp_path):
    """A chunked zarr v2 array (edge chunks cut, Fortran order) of which one
    chunk was never written, and one written equal to the fill value without
    being stored: the chunks as tensorstore reads them, the fill value
    where no chunk is."""
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}"},
            "path": "x", "create": True,
            "metadata": {"dtype": "<f4", "shape": [7, 5], "chunks": [3, 2], "fill_value": 7.5,
                         "order": "F",
                         "compressor": {"id": "zstd", "level": 1}},
            "store_data_equal_to_fill_value": False}
    arr = ts.open(spec).result()
    data = np.arange(35, dtype=np.float32).reshape(7, 5)
    arr[0:6, 0:4] = data[0:6, 0:4]
    arr[6:7, 0:2] = np.full((1, 2), 7.5, np.float32)   # equal to the fill: not stored
    want = arr.read().result()
    got = orbax_store.read_array(orbax_store.Database(str(tmp_path)), "x")
    assert got.dtype == np.float32 and got.tobytes() == np.ascontiguousarray(want).tobytes()
    assert got[6, 4] == 7.5 and got[2, 3] == data[2, 3]


def _corrupt(path: pathlib.Path, at: int) -> None:
    raw = bytearray(path.read_bytes())
    raw[at] ^= 0xFF
    path.write_bytes(bytes(raw))


@pytest.mark.parametrize("case", ["checksum", "compressor", "zarr3", "not_ocdbt",
                                  "value_type", "no_libzstd"])
def test_what_is_not_covered_raises(tmp_path, monkeypatch, case):
    """A broken checksum, a compressor other than zstd, zarr3, a store that is
    not OCDBT, a leaf of an unknown value type each raise
    ``OrbaxFormatError`` naming it; a missing libzstd raises ``OSError``
    naming it. Nothing returns data."""
    if case == "compressor":
        spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}"},
                "path": "x", "create": True,
                "metadata": {"dtype": "<f4", "shape": [4], "compressor": {"id": "zlib", "level": 1}}}
        ts.open(spec).result()[...] = np.ones(4, np.float32)
        with pytest.raises(orbax_store.OrbaxFormatError, match="compressor 'zlib'"):
            orbax_store.read_array(orbax_store.Database(str(tmp_path)), "x")
        return
    mgr = jx_checkpoint.CheckpointManager(str(tmp_path))
    mgr.save(1, toy_tree(1))
    mgr.close()
    step, item = tmp_path / "1", tmp_path / "1" / "default"
    meta = json.loads((item / "_METADATA").read_text())
    if case == "checksum":
        _corrupt(item / "manifest.ocdbt", 20)
        raised = pytest.raises(orbax_store.OrbaxFormatError, match="CRC-32C")
    elif case in ("zarr3", "not_ocdbt"):
        meta["use_zarr3" if case == "zarr3" else "use_ocdbt"] = case == "zarr3"
        raised = pytest.raises(orbax_store.OrbaxFormatError,
                               match="use_zarr3 is true" if case == "zarr3" else "use_ocdbt")
    elif case == "value_type":
        meta["tree_metadata"]["('s',)"]["value_metadata"]["value_type"] = "string"
        raised = pytest.raises(orbax_store.OrbaxFormatError, match="value type 'string'")
    else:
        monkeypatch.setattr(orbax_store, "_ZSTD", None)
        monkeypatch.setattr(orbax_store, "_ZSTD_LIBS", ("libzstd-missing.so.9",))
        monkeypatch.setattr(orbax_store.ctypes.util, "find_library", lambda name: None)
        raised = pytest.raises(OSError, match="libzstd not found")
    (item / "_METADATA").write_text(json.dumps(meta))
    with raised:
        orbax_store.read_step(step)


# ---------------------------------------------------------------------------
# a JAX training state through the port
# ---------------------------------------------------------------------------
SIZE = 128
FIELDS = dict(image_input_size=SIZE, backbone=CFG.backbone, d_model=CFG.d_model,
              num_layers=CFG.num_layers, num_heads=CFG.num_heads, dff=CFG.dff,
              compute_dtype="float32", warm_up_steps=10, batch_size=3, beam_search_n=2,
              decode_batch=2, epochs=1, n_val_dataset=2, dropout_rate=0.0,
              n_epoch_to_evaluate=100)


def configs(root: pathlib.Path, datadir: str, **kw):
    fields = dict(FIELDS, datadir=datadir, tokenizer_filename=str(root / "tok.json"),
                  additional_filename=str(root / "info.json"),
                  transformer_checkpoint_path=str(root / "ckpt"),
                  transformer_weight_path=str(root / "none.msgpack"),
                  result_dir=str(root / "results"), **kw)
    return JxConfig(**fields), Config(**fields)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX pipeline's init trained 2 steps on a split of 3 training
    images (one batch), saved at step 2 by its manager, and JAX's own
    restore of it."""
    root = tmp_path_factory.mktemp("orbax")
    datadir = make_synthetic_dataset(str(root / "data"), n_train=3, n_val=2, image_size=SIZE)
    jcfg, cfg = configs(root, datadir)
    dataset, max_seq_len, _ = jx_dataset.get_coco_images_dataset(
        datadir, jcfg.datatype_train, config=jcfg)
    (root / "info.json").write_text(json.dumps({"max_seq_len": max_seq_len,
                                                "mt_epoch_ckpt": 1}))
    jpipe = JxPipeline(jcfg.tokenizer_filename, jcfg.transformer_checkpoint_path, max_seq_len,
                       jcfg)
    (img, cap), = list(dataset)
    losses = [jpipe.train_step(img, cap) for _ in range(2)]
    jpipe.ckpt_manager.save(2, jpipe.state)
    restored = jx_checkpoint.CheckpointManager(jcfg.transformer_checkpoint_path).restore(
        jpipe.state)
    return dict(root=root, datadir=datadir, jcfg=jcfg, cfg=cfg, jpipe=jpipe, img=img, cap=cap,
                losses=losses, max_seq_len=max_seq_len,
                want=serialization.to_state_dict(restored))


def port_pipeline(world, ckpt) -> Pipeline:
    return Pipeline(world["cfg"].tokenizer_filename, world["max_seq_len"], world["cfg"],
                    device="cpu", checkpoint_path=str(ckpt))


def test_train_state_restores_as_jax_restores_it(world, tmp_path):
    """Every leaf of the port's restore (``params``, ``batch_stats``, the
    Keras-Adam ``count``/``m``/``v``/``vhat``, ``step``) bitwise equal to
    the JAX manager's own restore; the training pipeline built over the
    directory starts from it."""
    want = world["want"]
    assert int(want["step"]) == 2
    pipe = port_pipeline(world, world["cfg"].transformer_checkpoint_path)
    got = pipe.ckpt_manager.restore(pipe.state_tree())
    n = assert_leaves_bitwise(got, want)
    assert n == len(traverse_util.flatten_dict(want))
    assert pipe.state.step == 2 and pipe.state.opt_state.count == 2
    assert_leaves_bitwise(pipe.state_tree(), want)


def test_from_config_captions_as_the_restored_jax_pipeline(world):
    """No msgpack file: the port's ``from_config`` takes the latest Orbax
    step's weights, and its beam search gives the JAX pipeline's (restored
    from the same directory) ids."""
    jcfg = world["jcfg"]
    restored = JxPipeline(jcfg.tokenizer_filename, jcfg.transformer_checkpoint_path,
                          world["max_seq_len"], jcfg)
    pipe = Pipeline.from_config(world["cfg"], device="cpu")
    images = world["img"]
    want_seqs, want_lengths = restored.predict_batch(images)
    got_seqs, got_lengths = pipe.predict_batch(images)
    np.testing.assert_array_equal(got_seqs, np.asarray(want_seqs))
    np.testing.assert_array_equal(got_lengths, np.asarray(want_lengths))


def test_train_main_resumes_from_the_jax_checkpoint(world, tmp_path, monkeypatch, capsys):
    """The port's ``train`` main over a copy of the JAX directory restores
    step 2 and resumes at the sidecar's epoch for one step; its loss is the
    JAX pipeline's next step on the same batch within rtol 1e-3."""
    monkeypatch.chdir(tmp_path)
    shutil.copytree(world["cfg"].transformer_checkpoint_path, tmp_path / "ckpt")
    shutil.copy(world["cfg"].additional_filename, tmp_path / "info.json")
    cfg = world["cfg"].replace(transformer_checkpoint_path=str(tmp_path / "ckpt"),
                               additional_filename=str(tmp_path / "info.json"),
                               transformer_weight_path=str(tmp_path / "w.msgpack"), epochs=2)
    pipe = train_main(cfg, device="cpu")
    out = capsys.readouterr().out
    assert "Latest checkpoint restored!!" in out and "Epoch 1 / 2" not in out
    assert "Epoch 2 / 2" in out
    jcfg = world["jcfg"]
    jnext = JxPipeline(jcfg.tokenizer_filename, jcfg.transformer_checkpoint_path,
                       world["max_seq_len"], jcfg)
    want = jnext.train_step(world["img"], world["cap"])
    assert len(pipe.train_loss_history) == 1
    np.testing.assert_allclose(pipe.train_loss_history[0], want, rtol=1e-3)
    assert abs(want - world["losses"][0]) > 1e-2   # not the init's first step
    assert os.path.isfile(tmp_path / "w.msgpack")


def test_opt_state_mismatch_reinitialises_and_others_raise(world, tmp_path, capsys):
    """A JAX checkpoint whose ``opt_state`` is of another structure restores
    ``params``, ``batch_stats`` and ``step`` and re-initialises ``opt_state``
    with the warning, as the JAX manager does; one whose ``params`` or
    ``batch_stats`` differ raises ``ValueError``."""
    st = world["jpipe"].state
    mgr = jx_checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(3, JxTrainState(st.params, st.batch_stats, {"count": jnp.int32(9)}, st.step))
    extra = {**st.params, "extra": jnp.ones(3)}
    mgr.save(4, JxTrainState(extra, st.batch_stats, st.opt_state, st.step))
    stats = jax.tree.map(lambda x: x, st.batch_stats)
    first = next(iter(traverse_util.flatten_dict(stats)))
    flat = traverse_util.flatten_dict(stats)
    flat[first] = jnp.ones(7)
    mgr.save(5, JxTrainState(st.params, traverse_util.unflatten_dict(flat), st.opt_state,
                             st.step))
    mgr.close()
    pipe = port_pipeline(world, tmp_path / "port_ckpt")
    template = pipe.state_tree()
    mine = pt_checkpoint.CheckpointManager(str(tmp_path / "ckpt"))
    capsys.readouterr()
    got = mine.restore(template, step=3)
    assert "REINITIALIZED opt_state" in capsys.readouterr().out
    assert got["opt_state"] is template["opt_state"]
    assert_leaves_bitwise({k: got[k] for k in ("params", "batch_stats", "step")},
                          {k: world["want"][k] for k in ("params", "batch_stats", "step")})
    with pytest.raises(ValueError, match="'params' structure does not match"):
        mine.restore(template, step=4)
    with pytest.raises(ValueError, match="'batch_stats' leaf shapes/dtypes differ"):
        mine.restore(template, step=5)


def test_golden_checkpoint_reads_to_its_seed(tmp_path):
    """``tests/golden_torch/orbax/1`` (the smoke reads it on the card) holds
    what ``make_orbax_golden.golden_tree`` regenerates from its seed, bitwise,
    as the JAX manager restores it too."""
    import importlib.util

    path = pathlib.Path(__file__).parent / "golden_torch" / "make_orbax_golden.py"
    spec = importlib.util.spec_from_file_location("make_orbax_golden", path)
    golden = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(golden)
    want = golden.golden_tree(golden.SEED)
    got = orbax_store.read_step(golden.DIR / "1")
    flat_got, flat_want = (traverse_util.flatten_dict(t, sep="/") for t in (got, want))
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        assert np.asarray(flat_got[k]).dtype == v.dtype and flat_got[k].tobytes() == v.tobytes(), k
    assert isinstance(got["params"]["embedding"], orbax_store.BFloat16Bits)
    template = golden.golden_tree(golden.SEED)
    template["params"]["embedding"] = jnp.asarray(
        template["params"]["embedding"].view(jnp.bfloat16))
    shutil.copytree(golden.DIR, tmp_path / "orbax")   # the manager may write beside the steps
    restored = jx_checkpoint.CheckpointManager(str(tmp_path / "orbax")).restore(template, step=1)
    assert assert_leaves_bitwise(got, restored) == 7
