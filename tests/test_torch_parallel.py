"""The port's parallel layer in one process, against the JAX package: the
mesh's shape and its refusals, ``param_spec`` over the JAX package's own
parameter tree of a 2-layer, d 32 model on (4, 2), (8, 1) and renamed axes,
the placements of the port's parameters, the multi-process helpers'
single-process identities, the padding to the local data share, the corpus
shards, and the global-row dropout masks and sampling noise. The worlds of
several ranks are tests/test_torch_parallel_world.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from fixtures import make_synthetic_dataset
from fpn_mt_image_captioning_tpu.config import MeshConfig as JxMeshConfig
from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
from fpn_mt_image_captioning_tpu.parallel import mesh as jx_mesh
from fpn_mt_image_captioning_torch.config import Config, MeshConfig
from fpn_mt_image_captioning_torch.data.dataset import COCO_Images_ImageID, CocoCaptionDataset
from fpn_mt_image_captioning_torch.decode.noise import gumbel
from fpn_mt_image_captioning_torch.models.layers import Dropout
from fpn_mt_image_captioning_torch.models.transformer import Transformer
from fpn_mt_image_captioning_torch.parallel import collectives, multihost
from fpn_mt_image_captioning_torch.parallel.mesh import (MeshShape, flax_path, make_mesh,
                                                         mesh_shape, param_placements, param_spec)
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

VOCAB = 30
MESHES = {"4x2": (("data", "model"), (4, 2)), "8x1": (("data", "model"), (8, 1)),
          "renamed": (("dp", "tp"), (4, 2))}


def test_mesh_shape_and_refusal():
    """(data, model) from the world as the JAX ``make_mesh`` sizes it: -1
    fills the world; a shape the world does not fill raises."""
    assert mesh_shape(MeshConfig(data_axis_size=-1, model_axis_size=2), 8) == (4, 2)
    assert mesh_shape(MeshConfig(), 4) == (4, 1)
    assert mesh_shape(MeshConfig(data_axis_size=2, model_axis_size=2), 4) == (2, 2)
    for cfg, world in ((MeshConfig(data_axis_size=3, model_axis_size=2), 8),
                       (MeshConfig(model_axis_size=3), 8), (MeshConfig(model_axis_size=2), 1)):
        with pytest.raises(ValueError, match="ranks"):
            mesh_shape(cfg, world)
    jx_mesh.make_mesh(JxMeshConfig(data_axis_size=-1, model_axis_size=2))   # the same rule
    with pytest.raises(AssertionError):
        jx_mesh.make_mesh(JxMeshConfig(data_axis_size=3, model_axis_size=2))


def test_make_mesh_in_a_world_of_one(tmp_path):
    """A gloo world of one rank (set up by the caller): an explicit 1 × 1
    mesh with MeshConfig's names; a 1 × 2 mesh raises; a pipeline asked for
    the mesh in this world builds none, and one asked for 1 × 2 raises."""
    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(MeshConfig(data_axis="dp", model_axis="tp"), "cpu")
        assert mesh.mesh_dim_names == ("dp", "tp") and tuple(mesh.shape) == (1, 1)
        with pytest.raises(ValueError, match="1 ranks"):
            make_mesh(MeshConfig(model_axis_size=2), "cpu")
        assert multihost.maybe_initialize() is True
        assert multihost.process_shard() == (0, 1) and multihost.is_primary()
        from test_torch_slice import fit
        from fpn_mt_image_captioning_torch.data.tokenizer import Tokenizer

        cfg = Config(image_input_size=64, backbone="mobilenet224_0.35", d_model=32,
                     num_layers=1, num_heads=4, dff=64, mesh=MeshConfig(enabled=True))
        assert Pipeline(fit(Tokenizer), 8, cfg, seed=0, device="cpu").mesh is None
        with pytest.raises(ValueError, match="0x2 != 1 ranks"):
            Pipeline(fit(Tokenizer), 8, cfg.replace(mesh=MeshConfig(enabled=True,
                                                                     model_axis_size=2)),
                     seed=0, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def trees():
    """The JAX package's parameter tree of a 2-layer, d 32 model (shapes
    only) and a port model of the same configuration."""
    jm = JxTransformer(num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=64,
                       target_vocab_size=VOCAB, max_seq_len=8, backbone_name="mobilenet224_0.35")
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jm.init({"params": key, "dropout": key},
                                            jnp.zeros((1, 128, 128, 3)),
                                            jnp.zeros((1, 7), jnp.int32), True, None))
    flat = traverse_util.flatten_dict(shapes["params"], sep="/")
    with torch.device("meta"):
        port = Transformer(2, 32, 4, 64, 64, VOCAB, max_seq_len=8,
                           backbone_name="mobilenet224_0.35")
    return flat, port


@pytest.mark.parametrize("mesh", list(MESHES))
def test_param_spec_matches_jax(mesh, trees):
    """Every parameter of the JAX package's tree gets the JAX ``param_spec``
    (with its leaf: the divisibility fallback) on (4, 2), (8, 1) and a
    (dp, tp) mesh; the port's placements put the one sharded dimension of
    each port parameter where the spec puts it (a dense kernel transposed)."""
    names, shape = MESHES[mesh]
    jmesh = jx_mesh.make_mesh(JxMeshConfig(data_axis=names[0], model_axis=names[1],
                                           data_axis_size=shape[0],
                                           model_axis_size=shape[1]))
    flat, port = trees
    specs = {}
    for path, leaf in flat.items():
        want = tuple(jx_mesh.param_spec(path, leaf, True, jmesh))
        got = param_spec(path, leaf, True, MeshShape(names, shape))
        assert got == want, (path, got, want)
        specs[path] = got
    assert sum(any(s) for s in specs.values()) == 50     # every rule divides here
    placed = param_placements(MeshShape(names, shape), port)
    assert len(placed) == len(flat)
    for name, p in port.named_parameters():
        path, transposed = flax_path(port, name)
        dims = [i for i, a in enumerate(specs[path]) if a is not None]
        want = None if not dims else (p.ndim - 1 - dims[0] if transposed else dims[0])
        assert placed[name] == want, (name, placed[name], want)


def test_tp_rules_fallbacks():
    """The rules by path (tests/test_parallel.py's), replication without
    tp, on a data-only mesh, and where a dimension does not divide (a
    vocabulary of 31 over 2); the port's placements keep a whole
    attention where a shard would split a head."""
    assert param_spec("decoder/layer_0/mha1/wq/kernel") == (None, "model")
    assert param_spec("decoder/layer_0/mha1/out/kernel") == ("model", None)
    assert param_spec("encoder/layer_2/mva/wq") == (None, None, "model")
    assert param_spec("encoder/kv_proj") == (None, None, None, "model")
    assert param_spec("final_layer/kernel") == (None, "model")
    assert param_spec("decoder/embedding/embedding") == ()
    assert param_spec("encoder/feature_extractor/fpn/P3/kernel") == ()
    assert param_spec("anything", tp=False) == ()
    leaf = np.zeros((8, 16), np.float32)
    assert param_spec("decoder/layer_0/mha1/wq/kernel", leaf, True,
                      MeshShape(("data",), (8,))) == ()
    odd = MeshShape(("data", "model"), (4, 2))
    assert param_spec("final_layer/kernel", np.zeros((32, 31)), True, odd) == ()
    assert param_spec("final_layer/kernel", np.zeros((32, 30)), True, odd) == (None, "model")
    with torch.device("meta"):
        model = Transformer(1, 32, 2, 64, 64, 31, max_seq_len=8,
                            backbone_name="mobilenet224_0.35")
    placed = param_placements(MeshShape(("data", "model"), (1, 4)), model)
    assert placed["decoder.layer_0.mha1.wq.weight"] is None      # 2 heads over 4 ranks
    assert placed["encoder.kv_proj"] is None
    assert placed["decoder.layer_0.ffn.ffn1.weight"] == 0         # dff 64 divides
    assert placed["final_layer.weight"] is None                   # 31 does not


def test_multihost_single_process_identities(monkeypatch):
    """Without the launcher's environment: no process group, one process,
    the identity of every helper (int64 and 0-d rows exact)."""
    for k in multihost.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    assert multihost.maybe_initialize() is False
    assert multihost.process_shard() == (0, 1) and multihost.is_primary()
    assert multihost.world_size() == 1 and multihost.rank() == 0
    rows = np.arange(12).reshape(4, 3)
    np.testing.assert_array_equal(multihost.gather_rows(rows), rows)
    ids = np.array([2**40, -1], np.int64)
    out = multihost.gather_rows(ids)
    assert out.dtype == np.int64 and out.tolist() == ids.tolist()
    out = multihost.gather_rows(np.int64(2**40))
    assert out.shape == (1,) and out.dtype == np.int64 and out[0] == 2**40
    out = multihost.gather_rows(np.float64(1e-300))
    assert out.dtype == np.float64 and out[0] == 1e-300
    multihost.barrier("nothing")
    assert multihost.aligned_call(lambda a, b: a + b, "add", {}, 2, 3) == 5
    t = torch.arange(6.0).reshape(3, 2)
    assert multihost.globalize_batch(None, t) is t and multihost.localize_rows(t, None) is t
    for fn in (collectives.sum_over, collectives.replicated_input, collectives.sum_partials,
               collectives.gather_shards):
        assert fn(t, None) is t
    grads = [t.clone()]
    collectives.sum_tensors_(grads, None)
    assert torch.equal(grads[0], t)


def test_pad_batch_pads_to_local_share(monkeypatch):
    """Rows pad to the local share of the data axis (tests/test_multihost.py's
    case): one process feeding 8 data positions pads to 8, two feed 4 each."""
    from fpn_mt_image_captioning_torch.train import pipeline as pl

    pipe = Pipeline.__new__(Pipeline)
    pipe.mesh = MeshShape(("data", "model"), (8, 1))
    arr, pad = pipe._pad_batch(np.ones((9, 2), np.float32))
    assert (arr.shape[0], pad) == (16, 7)
    monkeypatch.setattr(pl, "world_size", lambda: 2)
    assert pipe._local_data_share == 4
    arr, pad = pipe._pad_batch(np.ones((9, 2), np.float32))
    assert (arr.shape[0], pad) == (12, 3) and not arr[9:].any()
    pipe.mesh = None
    assert pipe._local_data_share == 1


def test_predict_and_sample_refuse_ranks_without_mesh(monkeypatch):
    """In a world of several ranks without the mesh no rank knows where its
    rows go: ``predict_batch`` and ``sample_batch`` raise."""
    from fpn_mt_image_captioning_torch.train import pipeline as pl

    pipe = Pipeline.__new__(Pipeline)
    pipe.config, pipe.mesh = Config(), None
    monkeypatch.setattr(pl, "world_size", lambda: 2)
    with pytest.raises(NotImplementedError, match="mesh"):
        pipe.predict_batch(np.zeros((1, 32, 32, 3), np.float32))
    with pytest.raises(NotImplementedError, match="mesh"):
        pipe.sample_batch(np.zeros((1, 32, 32, 3), np.float32))


def test_corpus_shards(tmp_path):
    """Training shards are strided and of equal length (10 examples over 3
    shards: 3 each, one unused), each with a cache of its own; validation
    shards of a sharded iterator share the seed-0 permutation, disjoint and
    complete (tests/test_multihost.py:83-128's check)."""
    paths = [f"img_{i}.png" for i in range(10)]
    caps = np.arange(10)[:, None].repeat(4, 1)
    shards = [CocoCaptionDataset(paths, caps, 2, 64, shard_count=3, shard_index=i)
              for i in range(3)]
    assert [len(s.img_paths) for s in shards] == [3, 3, 3]
    assert [s.img_paths for s in shards] == [paths[0:9:3], paths[1:9:3], paths[2:9:3]]
    for s in shards:
        assert [int(c[0]) for c in s.captions_token] == [int(p[4:-4]) for p in s.img_paths]
    datadir = make_synthetic_dataset(str(tmp_path / "d"), n_train=2, n_val=9, image_size=64)
    val = [COCO_Images_ImageID(datadir, "val2017", None, image_size=64, shard_count=2,
                               shard_index=i).imgIds for i in (0, 1)]
    full = COCO_Images_ImageID(datadir, "val2017", None, image_size=64, seed=0).imgIds
    assert not set(val[0]) & set(val[1]) and sorted(val[0] + val[1]) == sorted(full)
    assert val[0] == full[0::2] and val[1] == full[1::2]


def test_global_rows_of_dropout_and_noise():
    """A rank's dropout mask and sampling noise are its rows of the global
    batch's: the same (seed, step, site) over 6 rows, cut at rows 2-4."""
    x = torch.ones(6, 3, 5)
    whole = Dropout(0.3, seed=1, step=2, device=torch.device("cpu"))(x, "site")
    part = Dropout(0.3, seed=1, step=2, device=torch.device("cpu"), rows=(2, 6))(x[2:4], "site")
    assert torch.equal(part, whole[2:4])
    g = lambda rows=None: gumbel(torch.Generator().manual_seed(4), (2 if rows else 6, 7),
                                 "cpu", rows)
    assert torch.equal(g((4, 6)), g()[4:6])
