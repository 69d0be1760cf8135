"""The port's Flax msgpack reader and writer (``weights.py``) against the JAX
package and the installed ``flax``/``msgpack``: the file the JAX package's
``Pipeline.save_weights`` writes (the perturbed variables of
``tests/test_torch_slice.py``) reads back bitwise equal and captions as JAX
does; the port's file is read by the JAX package's ``load_weights``, bitwise
equal; ``to_flax`` inverts ``from_flax``; chunked, bfloat16 and numpy-scalar
leaves; malformed bytes raise ``ValueError`` naming the offset; and a
hypothesis round trip against ``msgpack`` itself."""

import json

import flax.serialization as fs
import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import traverse_util
from hypothesis import given, settings
from hypothesis import strategies as st

from fixtures import make_synthetic_dataset
from fpn_mt_image_captioning_tpu.config import Config as JxConfig
from fpn_mt_image_captioning_tpu.data.tokenizer import store_tokenizer_to_path
from fpn_mt_image_captioning_tpu.train.pipeline import Pipeline as JxPipeline
from fpn_mt_image_captioning_torch import weights as W
from fpn_mt_image_captioning_torch.config import Config
from fpn_mt_image_captioning_torch.models.transformer import Transformer
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from test_torch_slice import CFG, MAX_LEN, SIZE, slice_variables

N_VAL = 5   # validation images of the synthetic split


def jax_world(root, checkpoint: bool = False) -> dict:
    """The slice's perturbed variables inside a JAX ``Pipeline`` (CPU, so its
    non-fused route), the Flax msgpack file its ``save_weights`` writes, and
    what both packages' entry points read: a synthetic split of ``N_VAL``
    images, the tokenizer file and the max_seq_len sidecar. With
    ``checkpoint``, also an Orbax checkpoint of the same state."""
    jx, jtok, variables, images = slice_variables()
    datadir = make_synthetic_dataset(str(root / "data"), n_train=1, n_val=N_VAL,
                                     image_size=SIZE)
    store_tokenizer_to_path(jtok, str(root / "tokenizer.json"))
    (root / "info.json").write_text(json.dumps({"max_seq_len": MAX_LEN}))
    fields = dict(image_input_size=SIZE, backbone=CFG.backbone, d_model=CFG.d_model,
                  num_layers=CFG.num_layers, num_heads=CFG.num_heads, dff=CFG.dff,
                  beam_search_n=CFG.beam_search_n, compute_dtype=CFG.compute_dtype,
                  datadir=datadir, tokenizer_filename=str(root / "tokenizer.json"),
                  additional_filename=str(root / "info.json"),
                  transformer_checkpoint_path=str(root / "ckpt"),
                  result_dir=str(root / "results"), decode_batch=2, n_val_dataset=N_VAL)
    jcfg = JxConfig(**fields)
    jpipe = JxPipeline(jcfg.tokenizer_filename, jcfg.transformer_checkpoint_path, MAX_LEN, jcfg)
    jpipe.state = jpipe.state._replace(params=variables["params"],
                                       batch_stats=variables["batch_stats"])
    weights = root / "weights.msgpack"
    jpipe.save_weights(str(weights))
    if checkpoint:
        jpipe.ckpt_manager.save(1, jpipe.state)
    return dict(jx=jx, jtok=jtok, variables=variables, images=images, jpipe=jpipe,
                jcfg=jcfg, cfg=Config(**fields, transformer_weight_path=str(weights)),
                weights=str(weights), root=root)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return jax_world(tmp_path_factory.mktemp("weights"))


def assert_trees_equal(got, want, path=""):
    """Same keys in the same order, leaves of the same type, bitwise equal;
    a port bfloat16 leaf (a torch tensor) against a numpy bfloat16 one."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and str(np.asarray(want).dtype) == "bfloat16", path
        assert got.shape == np.shape(want), path
        assert got.view(torch.int16).numpy().tobytes() == np.asarray(want).tobytes(), path
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert np.shape(got) == np.shape(want) and got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def assert_variables_equal(got, want):
    """Two ``{"params", "batch_stats"}`` trees hold the same paths with
    bitwise-equal leaves, in whatever key order."""
    assert set(got) == set(want)
    for name in want:
        have, need = (traverse_util.flatten_dict(t[name], sep="/") for t in (got, want))
        assert set(have) == set(need), name
        for k, v in need.items():
            a = np.asarray(have[k])
            assert a.dtype == v.dtype and a.shape == v.shape and a.tobytes() == v.tobytes(), k


def test_reads_the_jax_save_weights_file(world):
    """``read_flax_msgpack`` of the JAX package's file is
    ``flax.serialization.msgpack_restore`` of it, bitwise; a port pipeline
    that loads it serves the same variables and captions as the JAX one."""
    blob = open(world["weights"], "rb").read()
    tree = W.read_flax_msgpack(world["weights"])
    assert_trees_equal(tree, fs.msgpack_restore(blob))
    assert_trees_equal(tree, world["variables"])

    pipe = Pipeline(world["cfg"].tokenizer_filename, MAX_LEN, world["cfg"], device="cpu")
    pipe.load_weights(world["weights"])
    assert_variables_equal(W.to_flax(pipe.transformer), world["variables"])
    seqs, lengths = pipe.predict_batch(world["images"])
    j_seqs, j_len = world["jpipe"].predict_batch(world["images"])
    np.testing.assert_array_equal(seqs, j_seqs)
    np.testing.assert_array_equal(lengths, j_len)
    assert len({tuple(s) for s in seqs}) == len(seqs)   # not vacuous


def test_jax_load_weights_reads_the_port_file(world, tmp_path):
    """The port's ``save_weights`` writes the bytes ``flax.serialization``
    writes for the same tree, and the JAX package's ``load_weights`` reads
    them into bitwise-equal params and batch stats. Seeded port weights, so
    the loaded state differs from the one the JAX pipeline held. A bfloat16
    pipeline, which keeps only the rounded weights, refuses to save."""
    pipe = Pipeline(world["cfg"].tokenizer_filename, MAX_LEN, world["cfg"], seed=3,
                    device="cpu")
    path = tmp_path / "port.msgpack"
    pipe.save_weights(str(path))
    variables = W.to_flax(pipe.transformer)
    assert path.read_bytes() == fs.to_bytes(variables)
    jpipe = world["jpipe"]
    try:
        jpipe.load_weights(str(path))
        got = {"params": jpipe.state.params, "batch_stats": jpipe.state.batch_stats}
        assert_variables_equal(got, variables)
        assert not np.array_equal(np.asarray(got["params"]["final_layer"]["kernel"]),
                                  world["variables"]["params"]["final_layer"]["kernel"])
        # and back: the port reads its own file to the same variables
        again = Pipeline(world["cfg"].tokenizer_filename, MAX_LEN, world["cfg"], device="cpu")
        again.load_weights(str(path))
        assert_trees_equal(W.to_flax(again.transformer), variables)
    finally:
        jpipe.load_weights(world["weights"])
    bf16 = Pipeline(world["cfg"].tokenizer_filename, MAX_LEN,
                    world["cfg"].replace(compute_dtype="bfloat16"), seed=3, device="cpu")
    with pytest.raises(ValueError, match="compute_dtype='float32'"):
        bf16.save_weights(str(tmp_path / "bf16.msgpack"))
    assert not (tmp_path / "bf16.msgpack").exists()


def test_to_flax_inverts_from_flax(world):
    cfg = world["cfg"]
    with torch.device("meta"):
        model = Transformer(
            num_layers=cfg.num_layers, d_model=cfg.d_model, num_heads=cfg.num_heads,
            dff=cfg.dff, input_vocab_size=cfg.input_vocab_size,
            target_vocab_size=len(world["jtok"].index_word), max_seq_len=MAX_LEN,
            backbone_name=cfg.backbone)
    model.to_empty(device="cpu")
    model.load_state_dict(W.from_flax(world["variables"]), strict=True)
    back = W.to_flax(model)
    assert_variables_equal(back, world["variables"])
    state = W.from_flax(back)
    for k, t in model.state_dict().items():
        assert torch.equal(state[k], t), k


def test_chunked_bfloat16_and_scalar_leaves(monkeypatch, tmp_path):
    """A leaf above ``MAX_CHUNK_SIZE`` (made small on both sides) is written
    as Flax's chunk map and read back whole; a bfloat16 leaf comes back as a
    torch tensor with the same bits; numpy scalars stay numpy scalars."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 96)
    monkeypatch.setattr(W, "MAX_CHUNK_SIZE", 96)
    rng = np.random.default_rng(3)
    bf = np.asarray(jnp.asarray(rng.standard_normal((5, 7)), jnp.bfloat16))
    tree = {"params": {"big": rng.standard_normal((9, 11)).astype(np.float32),
                       "ids": np.arange(40, dtype=np.int64), "small": np.ones(3, np.float32),
                       "bf": bf, "bf_big": np.asarray(jnp.ones((80,), jnp.bfloat16))},
            "step": np.int32(12), "lr": np.float32(0.25), "flag": np.bool_(True)}
    blob = fs.to_bytes(tree)
    assert blob.count(b"__msgpack_chunked_array__") == 3
    path = tmp_path / "t.msgpack"
    path.write_bytes(blob)
    got = W.read_flax_msgpack(path)
    assert_trees_equal(got, fs.msgpack_restore(blob))
    assert isinstance(got["params"]["bf"], torch.Tensor)
    assert isinstance(got["step"], np.int32) and isinstance(got["lr"], np.float32)
    # the writer: bfloat16 as a torch tensor, the same bytes as flax's
    mine = dict(tree, params=dict(tree["params"], bf=got["params"]["bf"],
                                  bf_big=got["params"]["bf_big"]))
    out = tmp_path / "u.msgpack"
    W.write_flax_msgpack(out, mine)
    assert out.read_bytes() == blob


def _ndarray_ext(shape, name, data):
    payload = msgpack.packb((shape, name, data), use_bin_type=True)
    return msgpack.packb({"a": msgpack.ExtType(1, payload)})


@pytest.mark.parametrize("case", ["truncated", "foreign", "extra", "complex", "int_key",
                                  "bad_utf8", "short_buffer", "object_dtype", "bad_tuple",
                                  "bad_chunks"])
def test_malformed_bytes_raise_with_offset(case, tmp_path):
    good = fs.to_bytes({"params": {"k": np.arange(6, dtype=np.float32).reshape(2, 3)},
                        "batch_stats": {}})
    blobs = {
        "truncated": [good[:n] for n in (0, 1, 5, len(good) // 2, len(good) - 1)],
        "foreign": [b"\xc1", b"PK\x03\x04", b"\x93NUMPY"],   # never-used byte, a zip, .npy
        "extra": [good + b"\x00"],
        "complex": [fs.to_bytes({"c": 1 + 2j})],              # ext type 2
        "int_key": [msgpack.packb({1: 2})],
        "bad_utf8": [b"\x81\xa2\xff\xfe\x01"],
        "short_buffer": [_ndarray_ext([2, 3], "float32", b"\x00" * 20)],
        "object_dtype": [_ndarray_ext([1], "object", b"\x00" * 8)],
        "bad_tuple": [msgpack.packb({"a": msgpack.ExtType(1, msgpack.packb([1, 2]))})],
        "bad_chunks": [msgpack.packb({"__msgpack_chunked_array__": True, "shape": {"0": 4},
                                      "chunks": {"1": 5}})],
    }[case]
    for i, blob in enumerate(blobs):
        path = tmp_path / f"{case}{i}.msgpack"
        path.write_bytes(blob)
        with pytest.raises(ValueError, match="byte offset"):
            W.read_flax_msgpack(path)


DTYPES = ["float32", "float64", "float16", "int8", "int32", "int64", "uint8", "uint32",
          "bool", "complex64"]


@st.composite
def ndarrays(draw):
    dtype = np.dtype(draw(st.sampled_from(DTYPES)))
    shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
    raw = draw(st.binary(min_size=int(np.prod(shape)) * dtype.itemsize,
                         max_size=int(np.prod(shape)) * dtype.itemsize))
    a = np.frombuffer(raw, np.uint8).view(dtype).reshape(shape) if raw else \
        np.zeros(shape, dtype)
    if dtype.kind == "b":
        a = a.view(np.uint8) % 2 == 1
    return a


SCALARS = (st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40) | st.binary(max_size=300)
           | st.builds(np.float32, st.floats(width=32, allow_nan=False))
           | st.builds(np.int64, st.integers(-2**63, 2**63 - 1))
           | ndarrays())
TREES = st.recursive(SCALARS, lambda kids: st.lists(kids, max_size=20)
                     | st.dictionaries(st.text(max_size=40), kids, max_size=20), max_leaves=40)


def _same(a, b):
    if isinstance(b, dict):
        return isinstance(a, dict) and list(a) == list(b) and all(_same(a[k], b[k]) for k in b)
    if isinstance(b, list):
        return isinstance(a, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(b, (np.ndarray, np.generic)):
        return (type(a) is type(b) and a.dtype == b.dtype and np.shape(a) == np.shape(b)
                and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


@settings(max_examples=150, deadline=None)
@given(TREES)
def test_round_trip_against_msgpack(tree):
    """Bytes equal to ``msgpack.packb`` with Flax's ext encoder, and the tree
    ``msgpack.unpackb`` with Flax's ext decoder reads from them."""
    want = msgpack.packb(tree, default=fs._msgpack_ext_pack, strict_types=True)
    assert W._to_bytes(tree) == want
    back = msgpack.unpackb(want, ext_hook=fs._msgpack_ext_unpack, raw=False)
    assert _same(W._from_bytes(want), back)


def test_long_forms_against_msgpack():
    """Lengths past the one- and two-byte forms (str 32, bin 32, map 16,
    array 16) and every integer width."""
    tree = {"s" * 70000: "x" * 300, "b": b"\x00" * 70000,
            "m": {str(i): i for i in range(300)}, "l": list(range(20)),
            "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                     -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]}
    want = msgpack.packb(tree)
    assert W._to_bytes(tree) == want
    assert _same(W._from_bytes(want), msgpack.unpackb(want, raw=False))


@pytest.mark.parametrize("backbone", ["mobilenet224_0.35", "resnet50"])
def test_init_weights_draws_the_jax_initializers(backbone):
    """``init_weights`` draws every tensor from the family the JAX package's
    ``Transformer.init`` draws it from (lecun_normal backbones,
    glorot_uniform FPN and vocabulary layer, normal(0.01) head trunks,
    he_normal elsewhere): per tensor of at least 256 values, the standard
    deviation and the 99.9th percentile of the magnitude within 15 % of JAX's (the draws
    differ; a truncated normal, a uniform and a plain normal of one variance
    differ by 30 % or more in the 99.9th percentile of the magnitude). Smaller random
    tensors are only required to be random; constant ones equal."""
    from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer

    kw = dict(num_layers=1, d_model=64, num_heads=4, dff=128, input_vocab_size=1024,
              target_vocab_size=500, max_seq_len=8, backbone_name=backbone)
    net = Transformer(**kw)
    W.init_weights(net, torch.Generator().manual_seed(0))
    got = traverse_util.flatten_dict(W.to_flax(net), sep="/")
    jx = jax.jit(JxTransformer(**kw).init, static_argnums=(3, 4))(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 128, 128, 3)), jnp.ones((1, 4), jnp.int32), True, None)
    want = traverse_util.flatten_dict(jax.device_get(jx), sep="/")
    assert got.keys() == want.keys()
    checked = 0
    for k, w in want.items():
        w, g = np.asarray(w, np.float64), np.asarray(got[k], np.float64)
        assert g.shape == w.shape, k
        if w.std() == 0:
            assert np.all(g == w), k            # zeros, ones, (0, 1) statistics
            continue
        if w.size < 256:
            assert g.std() > 0, k
            continue
        assert 0.85 < g.std() / w.std() < 1.15, (k, g.std(), w.std())
        tail_g, tail_w = (np.quantile(np.abs(x), 0.999) for x in (g, w))
        assert 0.85 < tail_g / tail_w < 1.15, (k, tail_g, tail_w)
        checked += 1
    assert checked > 50
