"""The port's HDF5 writer (``utils/hdf5_writer.py``), ``write_keras_h5`` and
``apply_flat_updates`` (``utils/weight_import.py``) against the JAX
package's on the CPU: every file the port writes reads back bitwise through
three readers (h5py, the port's ``utils/hdf5.py`` and the JAX package's
``load_keras_h5``) and holds what the JAX package's h5py-written file of the
same layers holds; the flagship's Keras-named layers written by the port
import through JAX's ``import_retinanet_weights`` into the source's
variables; ``apply_flat_updates`` gives JAX's tree and report. Only this
test (and ``test_torch_hdf5.py``) imports ``h5py``; the port never does."""

import numpy as np
import pytest
from flax import traverse_util

from fpn_mt_image_captioning_torch.utils import hdf5, hdf5_writer
from fpn_mt_image_captioning_torch.utils import weight_import as pt_import
from fpn_mt_image_captioning_tpu.utils import weight_import as jx_import
from test_torch_backbones import flat
from test_torch_hdf5 import (GOLDEN, assert_reads_as_h5py, assert_trees_bitwise,
                             feature_extractor_tree)

h5py = pytest.importorskip("h5py")


def _layers(name: str, rng) -> dict:
    if name == "many_links":   # the root's members span 38 symbol nodes
        return {f"layer_{i:03d}": {"kernel:0": rng.standard_normal((3, 2)).astype(np.float32)}
                for i in range(300)}
    if name == "float64_and_integers":
        return {"arrays": {
            "f8:0": rng.standard_normal((2, 3)), "f2:0": np.float16([1.5, -2.0]),
            **{f"{t}:0": np.arange(-3, 4).astype(t) for t in ("i1", "i2", "i4", "i8")},
            **{f"{t}:0": np.arange(7).astype(t) for t in ("u1", "u2", "u4", "u8")},
            "scalar:0": np.float64(3.25)}}
    if name == "empty_dataset":
        return {"layer": {"empty:0": np.zeros((0, 3), np.float32),
                          "full:0": np.ones(3, np.float32)}}
    if name == "zero_d":
        return {"a": {"s:0": np.array(2.5, np.float32), "i:0": np.array(-7, np.int64)},
                "b": {"v:0": np.arange(4, dtype=np.int32)}}
    if name == "nested_names":   # a weight name with its own path, as a sub-model has
        return {"model": {"inner/conv/kernel:0": rng.standard_normal((2, 2)).astype(np.float32),
                          "inner/bn/gamma:0": rng.standard_normal(2).astype(np.float32)},
                "no_weights": {}}
    assert name == "golden"   # the Keras MobileNetV2 file's 104 layers, 260 datasets
    return jx_import.load_keras_h5(str(GOLDEN))


LAYOUTS = ["many_links", "float64_and_integers", "empty_dataset", "zero_d", "nested_names",
           "golden"]


def _leaves_equal(got: dict, want: dict) -> None:
    """``load_keras_h5`` keys a weight by the layer component of its full
    name ``<layer>/<weight name>``, the one before the last."""
    expect = {}
    for layer, weights in want.items():
        for name, arr in weights.items():
            *_, key, leaf = f"{layer}/{name}".split("/")
            expect.setdefault(key, {})[leaf] = np.asarray(arr)
    assert got.keys() == expect.keys()
    for key, weights in expect.items():
        assert got[key].keys() == weights.keys(), key
        for leaf, b in weights.items():
            a = got[key][leaf]
            assert a.dtype == b.dtype and a.shape == b.shape, (key, leaf)
            assert a.tobytes() == b.tobytes(), (key, leaf)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_file_reads_bitwise_through_three_readers(tmp_path, layout):
    layers = _layers(layout, np.random.default_rng(0))
    ours, theirs = tmp_path / "port.h5", tmp_path / "jax.h5"
    pt_import.write_keras_h5(str(ours), layers)
    jx_import.write_keras_h5(str(theirs), layers)
    with h5py.File(ours, "r") as f, h5py.File(theirs, "r") as g:
        # the port's reader reads the port's file as h5py does, and h5py
        # reads it as it reads the JAX package's file
        n = assert_reads_as_h5py(hdf5.File(ours), f)
        assert n == assert_reads_as_h5py(g, f)
    _leaves_equal(jx_import.load_keras_h5(str(ours)), layers)
    _leaves_equal(pt_import.load_keras_h5(str(ours)), layers)


def test_writer_tree_and_refusals(tmp_path):
    """Attributes of each covered kind on groups and the root; a dtype the
    writer does not cover raises ``ValueError`` naming it."""
    root = hdf5_writer.Tree()
    root.attrs["names"] = np.array([b"a", b"bcd"])
    root.attrs["scalar"] = np.float64(1.5)
    root.attrs["ints"] = np.arange(3, dtype=np.int16)
    root.group("g/h").dataset("x", np.arange(6, dtype=np.float32).reshape(2, 3))
    root.group("g").attrs["empty"] = np.array([])
    path = tmp_path / "t.h5"
    hdf5_writer.write(path, root)
    with h5py.File(path, "r") as f:
        assert assert_reads_as_h5py(hdf5.File(path), f) == 1
        assert f["g/h/x"][()].tolist() == [[0, 1, 2], [3, 4, 5]]
        assert f.attrs["scalar"] == 1.5 and f["g"].attrs["empty"].shape == (0,)
    for bad, what in ((np.array([True]), "bool"), (np.ones(2, ">f4"), ">f4"),
                      (np.ones(2, np.complex64), "complex64")):
        t = hdf5_writer.Tree()
        t.dataset("x", bad)
        with pytest.raises(ValueError, match=what):
            hdf5_writer.write(tmp_path / "bad.h5", t)
    t = hdf5_writer.Tree()
    t.dataset("x", np.ones(1))
    with pytest.raises(ValueError, match="dataset"):
        t.group("x/y")


def test_flagship_layers_written_by_port_import_through_jax(tmp_path):
    """The flagship's Keras-named layers (``retinanet_keras_layers``) written
    by the port and imported by the JAX package's ``import_retinanet_weights``
    give the source's variables wherever the import reaches, and the same
    trees and report as importing the JAX package's own file of them."""
    target = feature_extractor_tree("mobilenet224_1.0", 512, seed=1)
    source = feature_extractor_tree("mobilenet224_1.0", 512, seed=2)
    layers = pt_import.retinanet_keras_layers(source)
    ours, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    pt_import.write_keras_h5(ours, layers)
    jx_import.write_keras_h5(theirs, layers)
    got, rep = jx_import.import_retinanet_weights(target, ours)
    want, want_rep = jx_import.import_retinanet_weights(target, theirs)
    assert (rep.matched, rep.missed) == (want_rep.matched, want_rep.missed)
    assert rep.missed == [] and len(rep.matched) == 260 + 16 + 8
    assert_trees_bitwise(got, want)
    fe_got, fe_src = (flat(t["params"]["encoder"]["feature_extractor"]) for t in (got, source))
    for k in fe_got:
        if k.split("/")[0] in ("backbone", "fpn", "regression_trunk", "classification_trunk"):
            assert np.array_equal(fe_got[k], fe_src[k]), k
    stats_got, stats_src = (flat(t["batch_stats"]) for t in (got, source))
    assert stats_got.keys() == stats_src.keys()
    assert all(np.array_equal(stats_got[k], stats_src[k]) for k in stats_src)


def _params(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"params": {"encoder": {"w": rng.standard_normal((3, 2)).astype(np.float32),
                                   "b": np.zeros(2, np.float32), "empty": {}},
                       "decoder": {"layer_0": {"k": rng.standard_normal(4).astype(np.float32),
                                               "n": np.arange(3, dtype=np.int32)}}},
            "batch_stats": {"bn": {"mean": np.ones(2, np.float32)}}}


@pytest.mark.parametrize("case", ["matched_and_missed", "cast", "shape_mismatch"])
def test_apply_flat_updates_matches_jax(case):
    variables = _params(0)
    rng = np.random.default_rng(1)
    updates = {"encoder/w": rng.standard_normal((3, 2)), "decoder/layer_0/n": np.float64([5, 6, 7])}
    if case == "matched_and_missed":
        updates.update({"encoder/missing": np.ones(1), "decoder/layer_1/k": np.ones(4)})
    if case == "shape_mismatch":
        updates["decoder/layer_0/k"] = np.ones(5)
        for fn in (jx_import.apply_flat_updates, pt_import.apply_flat_updates):
            with pytest.raises(ValueError, match="shape mismatch at decoder/layer_0/k"):
                fn(variables, updates)
        return
    want, want_rep = jx_import.apply_flat_updates(variables, updates)
    got, rep = pt_import.apply_flat_updates(variables, updates)
    assert (rep.matched, rep.missed) == (want_rep.matched, want_rep.missed)
    assert list(got) == list(want) and got["batch_stats"] is variables["batch_stats"]
    # the same paths (JAX's tree map sorts the keys; the port keeps the order)
    g, w = (traverse_util.flatten_dict(t["params"], sep="/") for t in (got, want))
    assert g.keys() == w.keys()
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    assert np.array_equal(variables["params"]["encoder"]["w"], _params(0)["params"]["encoder"]["w"])
