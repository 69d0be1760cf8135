"""The port's own HDF5 reader (``utils/hdf5.py``) against ``h5py``, and the
Keras ``.h5`` RetinaNet import (``utils/weight_import.py``) against the JAX
package's, on the CPU: the golden Keras MobileNetV2 file and files the JAX
package's ``write_keras_h5`` (and h5py) write read exactly as h5py reads
them; what the reader does not cover raises ``ValueError`` naming it and its
byte offset; the import gives JAX's trees and report; ``Pipeline.from_config``
and the ``train`` main boot from the file as the JAX package boots. Only this
test imports ``h5py``; the port never does."""

import pathlib

import numpy as np
import pytest
import torch

from fixtures import make_synthetic_dataset
from fpn_mt_image_captioning_tpu.utils import weight_import as jx_import
from fpn_mt_image_captioning_torch.config import Config
from fpn_mt_image_captioning_torch.data.tokenizer import Tokenizer, store_tokenizer_to_path
from fpn_mt_image_captioning_torch.models.feature_extractor import FeatureExtractor
from fpn_mt_image_captioning_torch.train.__main__ import main as train_main
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from fpn_mt_image_captioning_torch.utils import hdf5
from fpn_mt_image_captioning_torch.utils import weight_import as pt_import
from fpn_mt_image_captioning_torch.weights import to_flax
from test_torch_backbones import flat, one_torch_thread, seeded  # noqa: F401 (fixture)
from test_torch_slice import fit

h5py = pytest.importorskip("h5py")

GOLDEN = pathlib.Path(__file__).parent / "golden" / "mobilenet_v2_a035.h5"


def assert_reads_as_h5py(ours, theirs) -> int:
    """Same members in the same order, same attributes (type, dtype and
    value), every dataset bitwise equal; returns the datasets compared."""
    assert list(ours) == list(theirs), theirs.name
    assert set(ours.attrs) == set(theirs.attrs), theirs.name
    for k, want in theirs.attrs.items():
        got = ours.attrs[k]
        assert type(got) is type(want) and got.dtype == want.dtype, (theirs.name, k)
        assert np.shape(got) == np.shape(want) and np.array_equal(got, want), (theirs.name, k)
    n = 0
    for name, obj in theirs.items():
        if isinstance(obj, h5py.Group):
            n += assert_reads_as_h5py(ours[name], obj)
            continue
        got, want = np.asarray(ours[name]), obj[()]
        assert got.dtype == want.dtype and got.shape == np.shape(want), obj.name
        assert got.tobytes() == np.asarray(want).tobytes(), obj.name
        n += 1
    return n


def test_golden_keras_file_reads_as_h5py():
    """The Keras MobileNetV2 (alpha 0.35) weights file: superblock 0, 104
    layer groups (the root's links span several symbol nodes), 260 float32
    datasets, fixed-length string attributes."""
    with h5py.File(GOLDEN, "r") as f:
        ours = hdf5.File(GOLDEN)
        assert len(ours) == 104 and ours.attrs["layer_names"].dtype == np.dtype("S26")
        assert assert_reads_as_h5py(ours, f) == 260


def nested_submodel(path, rng):
    """A backbone wrapped as a sub-model (tests/test_weight_import.py): one
    top-level group whose ``weight_names`` carry the inner layers' paths."""
    inner = {"Conv1/kernel:0": rng.standard_normal((3, 3, 3, 32)).astype(np.float32),
             "bn_Conv1/gamma:0": rng.standard_normal(32).astype(np.float32),
             "expanded_conv_depthwise/depthwise_kernel:0":
                 rng.standard_normal((3, 3, 32, 1)).astype(np.float32)}
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = np.array([b"mobilenetv2_1.00_224"])
        g = f.create_group("mobilenetv2_1.00_224")
        g.attrs["weight_names"] = np.array([k.encode() for k in inner])
        for k, v in inner.items():
            g.create_dataset(k, data=v)


def compact_layout(path, rng):
    """A dataset whose data sit in its layout message (h5py writes the
    compact layout when asked)."""
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=rng.standard_normal((2, 3)).astype(np.float32), dcpl=dcpl)
        f["x"].attrs["unit"] = np.bytes_(b"none")


WRITTEN = {
    "nested_submodel": nested_submodel,
    "compact_layout": compact_layout,
    # 300 groups: the root's symbol table spans ~40 symbol nodes under a
    # two-level B-tree
    "many_links": lambda path, rng: jx_import.write_keras_h5(path, {
        f"layer_{i:03d}": {"kernel:0": rng.standard_normal((3, 2)).astype(np.float32)}
        for i in range(300)}),
    "float64_and_integers": lambda path, rng: jx_import.write_keras_h5(path, {"arrays": {
        "f8:0": rng.standard_normal((2, 3)), "f2:0": np.float16([1.5, -2.0]),
        **{f"{t}:0": np.arange(-3, 4).astype(t) for t in ("i1", "i2", "i4", "i8")},
        **{f"{t}:0": np.arange(7).astype(t) for t in ("u1", "u2", "u4", "u8")},
        "scalar:0": np.float64(3.25)}}),
    "empty_dataset": lambda path, rng: jx_import.write_keras_h5(path, {"layer": {
        "empty:0": np.zeros((0, 3), np.float32), "full:0": np.ones(3, np.float32)}}),
}


@pytest.mark.parametrize("layout", list(WRITTEN))
def test_written_files_read_as_h5py(tmp_path, layout):
    path = tmp_path / "w.h5"
    WRITTEN[layout](str(path), np.random.default_rng(0))
    with h5py.File(path, "r") as f:
        assert assert_reads_as_h5py(hdf5.File(path), f) > 0


def _with(path, build, **kw):
    with h5py.File(path, "w", **kw) as f:
        build(f)


REFUSED = {
    "gzip_chunked": (lambda f: f.create_dataset("x", data=np.ones((50, 50)),
                                                compression="gzip"), "filter pipeline"),
    "chunked": (lambda f: f.create_dataset("x", data=np.ones((50, 50)), chunks=(10, 10)),
                "chunked data layout"),
    "variable_length_string": (lambda f: f.attrs.__setitem__("x", "a str"),
                               "variable-length datatype"),
    "big_endian": (lambda f: f.create_dataset("x", data=np.ones(3, ">f4")), "big-endian"),
    "soft_link": (lambda f: f.__setitem__("x", h5py.SoftLink("/nowhere")), "soft link"),
    "unallocated": (lambda f: f.create_dataset("x", shape=(3,), dtype="f4"),
                    "no storage allocated"),
}


def read_all(node) -> None:
    """Every attribute and dataset below ``node``, as a caller would read them."""
    dict(node.attrs)
    for name in node:
        child = node[name]
        if isinstance(child, hdf5.Group):
            read_all(child)
        else:
            child.read()


@pytest.mark.parametrize("case", list(REFUSED) + ["libver_latest", "truncated"])
def test_what_is_not_covered_raises_with_its_offset(tmp_path, case):
    """A gzip-compressed chunked dataset, a chunked one, a variable-length
    string, a big-endian float, a soft link, a dataset never written, a file
    of ``libver="latest"`` (superblock 3) and a truncated file each raise
    ``ValueError`` naming what was found and the byte offset; nothing
    returns data."""
    path = tmp_path / "r.h5"
    if case == "libver_latest":
        _with(path, lambda f: f.create_dataset("x", data=np.ones(3)), libver="latest")
        match = "superblock version 3"
    elif case == "truncated":
        path.write_bytes(GOLDEN.read_bytes()[:GOLDEN.stat().st_size // 2])
        match = "truncated"
    else:
        build, match = REFUSED[case]
        _with(path, build)
    with pytest.raises(ValueError, match=match) as err:
        read_all(hdf5.File(path))
    assert "byte offset" in str(err.value)


def test_missing_file_raises_oserror(tmp_path):
    with pytest.raises(OSError):
        hdf5.File(tmp_path / "missing.h5")
    with pytest.raises(OSError):
        pt_import.load_keras_h5(str(tmp_path / "missing.h5"))


# ---------------------------------------------------------------------------
# import_retinanet_weights against the JAX package's
# ---------------------------------------------------------------------------
def feature_extractor_tree(backbone: str, d_model: int, seed: int) -> dict:
    """A seeded Transformer-shaped tree holding only the feature extractor
    (what the import reads and writes)."""
    with torch.device("meta"):
        fe = FeatureExtractor(backbone, d_model)
    tree = seeded(to_flax(fe.to_empty(device="cpu")), seed)
    return {c: {"encoder": {"feature_extractor": t}} for c, t in tree.items()}


def assert_trees_bitwise(got, want) -> None:
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("case", ["flagship", "alpha_0.35", "resnet50"])
def test_import_gives_jax_trees_and_report(tmp_path, case):
    """On the same file, the port's ``import_retinanet_weights`` gives the
    JAX package's trees, bitwise, and the same ``matched``/``missed`` lists:
    the flagship's feature extractor (mobilenet224_1.0, d 512) from a
    Keras-named file of another seeded one (``retinanet_keras_layers``),
    which it then equals wherever the import reaches (backbone, FPN with
    P6/P7 by file order, head trunks) and nowhere else; the golden Keras
    file into alpha 0.35 (backbone matched, FPN and trunks missed); and into
    a ResNet-50 one, whose backbone is all missed."""
    if case == "flagship":
        target = feature_extractor_tree("mobilenet224_1.0", 512, seed=1)
        source = feature_extractor_tree("mobilenet224_1.0", 512, seed=2)
        path = str(tmp_path / "flagship.h5")
        jx_import.write_keras_h5(path, pt_import.retinanet_keras_layers(source))
    else:
        target = feature_extractor_tree("mobilenet224_0.35" if case == "alpha_0.35" else case,
                                        32, seed=3)
        path = str(GOLDEN)
    want, jrep = jx_import.import_retinanet_weights(target, path)
    got, prep = pt_import.import_retinanet_weights(target, path)
    assert (prep.matched, prep.missed) == (jrep.matched, jrep.missed)
    assert_trees_bitwise(got, want)
    assert_trees_bitwise(target, feature_extractor_tree(  # the input is left as it was
        "mobilenet224_1.0" if case == "flagship" else
        "mobilenet224_0.35" if case == "alpha_0.35" else case,
        512 if case == "flagship" else 32, seed=1 if case == "flagship" else 3))
    if case == "flagship":
        # 52 conv+BN pairs × 5 leaves, 8 FPN convs and 4 trunk convs × 2
        assert prep.missed == [] and len(prep.matched) == 260 + 16 + 8
        fe_got, fe_src, fe_tgt = (flat(t["params"]["encoder"]["feature_extractor"])
                                  for t in (got, source, target))
        for k in fe_got:
            reached = k.split("/")[0] in ("backbone", "fpn", "regression_trunk",
                                          "classification_trunk")
            want_leaf = fe_src[k] if reached else fe_tgt[k]
            assert np.array_equal(fe_got[k], want_leaf), k
    elif case == "alpha_0.35":
        assert len(prep.matched) == 260 and len(prep.missed) == 12
    else:
        assert prep.matched == [] and len(prep.missed) == 272


# ---------------------------------------------------------------------------
# booting from the .h5
# ---------------------------------------------------------------------------
SIZE, MAX_LEN = 128, 8
FIELDS = dict(image_input_size=SIZE, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
              num_heads=4, dff=64, compute_dtype="float32", beam_search_n=2, batch_size=2,
              decode_batch=2, epochs=1, n_val_dataset=1, warm_up_steps=10)


@pytest.fixture(scope="module")
def boot(tmp_path_factory):
    """A Keras-named file of a seeded mobilenet224_0.35 feature extractor
    (backbone, FPN, head trunks), a tokenizer and sidecar, a small split."""
    root = tmp_path_factory.mktemp("boot")
    layers = pt_import.retinanet_keras_layers(feature_extractor_tree("mobilenet224_0.35", 32, 4))
    jx_import.write_keras_h5(str(root / "retinanet.h5"), layers)
    store_tokenizer_to_path(fit(Tokenizer), str(root / "tok.json"))
    (root / "info.json").write_text(f'{{"max_seq_len": {MAX_LEN}}}')
    datadir = make_synthetic_dataset(str(root / "data"), n_train=2, n_val=1, image_size=SIZE)
    cfg = Config(**FIELDS, datadir=datadir, tokenizer_filename=str(root / "tok.json"),
                 additional_filename=str(root / "info.json"),
                 transformer_checkpoint_path=str(root / "ckpt"),
                 transformer_weight_path=str(root / "none.msgpack"),
                 result_dir=str(root / "results"), retinanet_weight_path=str(root / "retinanet.h5"))
    return dict(root=root, cfg=cfg, h5=str(root / "retinanet.h5"))


def jax_boot(cfg: Config, max_len: int):
    """What the JAX package's boot gives from the port's seeded init: its
    ``import_retinanet_weights`` of the file into those variables (as its
    ``Pipeline.load_pretrained_retinanet`` does), and the report line it
    prints."""
    pipe = Pipeline(cfg.tokenizer_filename, max_len, cfg.replace(retinanet_weight_path=None),
                    device="cpu")
    variables, report = jx_import.import_retinanet_weights(
        to_flax(pipe.transformer), cfg.retinanet_weight_path,
        n_conv_submodule=cfg.n_conv_submodule)
    return variables, f"Loaded pretrained retinanet weights: {report!r}"


def test_from_config_boots_from_the_h5_as_jax(boot, capsys):
    """With no weight file and no checkpoint, ``Pipeline.from_config`` serves
    the seeded init with the file imported into its feature extractor:
    bitwise what the JAX package's import gives from the same init, the same
    report printed."""
    pipe = Pipeline.from_config(boot["cfg"], device="cpu")
    want, line = jax_boot(boot["cfg"], MAX_LEN)
    assert line in capsys.readouterr().out
    assert_trees_bitwise(to_flax(pipe.transformer), want)
    seqs, _ = pipe.predict_batch(np.zeros((1, SIZE, SIZE, 3), np.uint8))
    assert seqs.shape == (1, MAX_LEN)


class _FirstStep(Exception):
    pass


def test_train_main_boots_from_the_h5_as_jax(boot, tmp_path, monkeypatch, capsys):
    """The ``train`` main with ``--retinanet_weight_path`` and no checkpoint
    starts its first step from the seeded init with the file imported,
    bitwise what the JAX package's import gives, and prints the same report
    (the tokenizer and ``max_seq_len`` are the ones the main derives from
    the split)."""
    monkeypatch.chdir(tmp_path)
    cfg = boot["cfg"].replace(transformer_checkpoint_path=str(tmp_path / "ckpt"),
                              tokenizer_filename=str(tmp_path / "tok.json"),
                              additional_filename=str(tmp_path / "info.json"))
    seen = []

    def first_step(self, img, caps):
        seen.append((to_flax(self.state.model), self.max_seq_len))
        raise _FirstStep

    monkeypatch.setattr(Pipeline, "train_step", first_step)
    with pytest.raises(_FirstStep):
        train_main(cfg, device="cpu")
    (booted, max_len), = seen
    want, line = jax_boot(cfg, max_len)
    assert line in capsys.readouterr().out
    assert_trees_bitwise(booted, want)


def test_missing_h5_raises_oserror(boot, tmp_path):
    cfg = boot["cfg"].replace(retinanet_weight_path=str(tmp_path / "missing.h5"))
    with pytest.raises(OSError):
        Pipeline.from_config(cfg, device="cpu")
    with pytest.raises(OSError):
        Pipeline(cfg.tokenizer_filename, MAX_LEN, cfg, device="cpu",
                 checkpoint_path=str(tmp_path / "ckpt"))
