"""Each backbone family's whole model in the port against the JAX package's,
on the CPU: the smallest depth of each (ResNet-50, VGG16, DenseNet-121) at
the small widths of tests/test_baseline_configs.py (128², d 32, 2+2
layers), on numpy-seeded weights (BatchNorm statistics calibrated on a
seeded batch): ``encode`` and the fast beam search at beams 2 and 8,
``Pipeline.predict_batch`` against the JAX ``Pipeline``,
``fused_backbone=True`` encoding eagerly, the weight files (the Flax
msgpack file and the ``TrainState``) bitwise across the packages, and one
training step's loss and gradients. The JAX side runs jitted; its
``Pipeline``s take the seeded variables in place of their jitted init.
Each tolerance is stated where it is used."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization, traverse_util
from PIL import Image

from fixtures import make_synthetic_dataset
from fpn_mt_image_captioning_tpu.config import Config as JxConfig
from fpn_mt_image_captioning_tpu.data.tokenizer import Tokenizer as JxTokenizer
from fpn_mt_image_captioning_tpu.data.tokenizer import store_tokenizer_to_path
from fpn_mt_image_captioning_tpu.decode.beam_search import beam_search as jx_beam_search
from fpn_mt_image_captioning_tpu.models.backbones import densenet as jx_densenet
from fpn_mt_image_captioning_tpu.models.backbones import resnet as jx_resnet
from fpn_mt_image_captioning_tpu.models.backbones import vgg as jx_vgg
from fpn_mt_image_captioning_tpu.models.positional import create_masks as jx_masks
from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
from fpn_mt_image_captioning_tpu.ops.fused_backbone import (
    supports_fused_backbone as jx_supports_fused_backbone)
from fpn_mt_image_captioning_tpu.train import losses as jx_losses
from fpn_mt_image_captioning_tpu.train.pipeline import Pipeline as JxPipeline
from fpn_mt_image_captioning_tpu.train.pipeline import TrainState as JxTrainState
from fpn_mt_image_captioning_torch import caption as pt_caption
from fpn_mt_image_captioning_torch.config import Config
from fpn_mt_image_captioning_torch.decode.beam_search import beam_search, greedy_decode
from fpn_mt_image_captioning_torch.models.backbones import densenet, resnet, vgg
from fpn_mt_image_captioning_torch.models.positional import create_masks
from fpn_mt_image_captioning_torch.models.transformer import Transformer
from fpn_mt_image_captioning_torch.ops.fused_backbone import supports_fused_backbone
from fpn_mt_image_captioning_torch.train import losses
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from fpn_mt_image_captioning_torch.weights import (_flax_tree, from_flax, read_flax_msgpack,
                                                   to_flax, write_flax_msgpack)
from test_torch_backbones import (FAMILIES, calibrated, flat,  # noqa: F401 (a fixture)
                                  one_torch_thread, seeded)
from test_torch_slice import fit

# the small widths of tests/test_baseline_configs.py
SIZE, MAX_LEN, BEAMS = 128, 8, (2, 8)
MODEL = dict(num_layers=2, d_model=32, num_heads=4, dff=64)


def config_fields(name: str, root, size: int = SIZE, fused_backbone: bool = True) -> dict:
    """Both packages' config: ``fused_backbone=True``, which these backbones
    ignore (so every test here holds the eager encode under it); the JAX
    ``Pipeline`` builds its ``MetricEval`` from a validation split, so there
    is a one-image one."""
    datadir = make_synthetic_dataset(str(root / "data"), n_train=1, n_val=1, image_size=size)
    return dict(image_input_size=size, backbone=name, **MODEL, beam_search_n=BEAMS[1],
                compute_dtype="float32", dropout_rate=0.0, datadir=datadir,
                fused_backbone=fused_backbone,
                tokenizer_filename=str(root / "tok.json"),
                transformer_checkpoint_path=str(root / "ckpt"))


def build_family(name: str, root, size: int = SIZE, fused_backbone: bool = True) -> dict:
    """One family's model: numpy-seeded variables (BatchNorm calibrated on a
    seeded batch) in a port ``Pipeline`` (CPU) and a JAX ``Pipeline`` (its
    jitted init replaced by those variables: compiling DenseNet-121's init
    costs ~15 s), three seeded ``size``² uint8 images."""
    jtok = fit(JxTokenizer)
    store_tokenizer_to_path(jtok, str(root / "tok.json"))
    fields = config_fields(name, root, size, fused_backbone)
    cfg = Config(**fields)
    seed = FAMILIES.index(name) if name in FAMILIES else len(FAMILIES)
    with torch.device("meta"):
        model = Transformer(**MODEL, input_vocab_size=cfg.input_vocab_size,
                            target_vocab_size=len(jtok.index_word), max_seq_len=MAX_LEN,
                            backbone_name=name)
    model = model.to_empty(device="cpu")
    model.load_state_dict(from_flax(seeded(to_flax(model), seed)), strict=True)
    calib = np.random.default_rng(10 + seed).integers(0, 256, (2, size, size, 3), np.uint8)
    variables = calibrated(model, lambda: model.encoder.features(torch.from_numpy(calib),
                                                                 train=True), seed)
    variables = {c: v for c, v in variables.items() if v}
    pipe = Pipeline(cfg.tokenizer_filename, MAX_LEN, cfg, variables, device="cpu")
    params, stats = variables["params"], variables.get("batch_stats", {})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JxPipeline, "_init_state",
                   lambda self: JxTrainState(params, stats, None, jnp.int32(0)))
        jpipe = JxPipeline(cfg.tokenizer_filename, cfg.transformer_checkpoint_path, MAX_LEN,
                           JxConfig(**fields))
    imgs = np.random.default_rng(4).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
    return dict(name=name, root=root, cfg=cfg, pipe=pipe, jpipe=jpipe, variables=variables,
                images=imgs)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request, tmp_path_factory):
    world = build_family(request.param, tmp_path_factory.mktemp(request.param))
    yield world
    world["jpipe"].close()


# depths cut (in both packages' tables, for one test) where the full depth
# costs more than the test shows: JAX's gradient of ResNet-50 compiles in
# ~15 s, DenseNet-121's in ~37 s; a train state of ResNet-50 is 400 MB.
# Every layer kind stays, at the published widths.
CUT = {"resnet50": [(jx_resnet._DEPTH_BLOCKS, resnet.DEPTH_BLOCKS), 50, (1, 1, 1, 1)],
       "vgg16": [(jx_vgg._CFG, vgg.BLOCKS), 16, ((64, 1), (128, 1), (256, 1), (512, 1),
                                                  (512, 1))],
       "densenet121": [(jx_densenet._DEPTH_BLOCKS, densenet.DEPTH_BLOCKS), 121, (2, 2, 2, 2)]}


def cut_depth(monkeypatch, name: str) -> None:
    tables, depth, cut = CUT[name]
    for table in tables:
        monkeypatch.setitem(table, depth, cut)


@pytest.mark.parametrize("beam", BEAMS)
def test_encode_and_beam_search_match_jax(family, beam):
    """``encode`` within atol 1e-4 of the JAX ``Pipeline``'s jitted encode,
    then, on that same encoder output, the fast beam search on both of the
    port's steps (the fused step's plain version, and the non-fused
    KV-cached step) equal to JAX's non-fused ``beam_search``: sequences and
    lengths exact, scores within 1e-4."""
    check_encode_and_beam_search(family, beam, lenc=1)   # P6's view at 128²: 1²


@pytest.mark.parametrize("name", ["resnet50", "mobilenet224_0.35"])
def test_non_power_of_two_size_matches_jax(name, tmp_path):
    """At 200², a size no power of two divides past 8 (P3..P7 at 25, 13, 7,
    4 and 2 cells a side, TF-SAME padding odd at every stride): ResNet-50's
    and MobileNetV2's eager encode and beam search (beam 8) against JAX's at
    the bars of ``test_encode_and_beam_search_match_jax``. (The fused
    MobileNetV2 backbone needs a multiple of 32 and refuses 200², as the
    JAX package's does.)"""
    world = build_family(name, tmp_path, size=200, fused_backbone=False)
    check_encode_and_beam_search(world, BEAMS[1], lenc=1)
    world["jpipe"].close()


def check_encode_and_beam_search(family, beam: int, lenc: int) -> None:
    pipe, jpipe = family["pipe"], family["jpipe"]
    want = np.array(jpipe._encode(jpipe.variables, jnp.asarray(family["images"])))
    got = pipe.encode(family["images"])
    assert got.shape == (3, lenc, MODEL["d_model"]) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    j_seqs, j_len, j_scores = jx_beam_search(
        jpipe.transformer, jpipe.variables, jnp.asarray(want), beam_n=beam,
        max_len=MAX_LEN, start_token=jpipe.start_token, end_token=jpipe.end_token,
        parity=False, fused=False, pack_dtype=jnp.dtype("float32"))
    for fused in (True, False):
        seqs, lengths, scores = beam_search(
            pipe.transformer, torch.from_numpy(want), beam_n=beam, max_len=MAX_LEN,
            start_token=pipe.start_token, end_token=pipe.end_token, fused=fused,
            packed=pipe.packed if fused else None)
        np.testing.assert_array_equal(seqs.numpy(), np.asarray(j_seqs))
        np.testing.assert_array_equal(lengths.numpy(), np.asarray(j_len))
        np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores), atol=1e-4, rtol=0)
    if family["images"].shape[1] == SIZE:
        assert len(np.unique(np.round(scores.numpy(), 3))) == 3   # each image its own score
    else:   # each image its own score, further apart than twice their bar
        assert np.diff(np.sort(scores.numpy())).min() > 2e-4


def test_predict_batch_matches_jax_pipeline(family):
    """``Pipeline.predict_batch`` (uint8 in, beam 8) equals the JAX
    ``Pipeline``'s. (Seeded weights leave these captions alike across the
    images; the beam search's scores, which differ by image, are held in
    ``test_encode_and_beam_search_match_jax``.)"""
    seqs, lengths = family["pipe"].predict_batch(family["images"])
    j_seqs, j_len = family["jpipe"].predict_batch(family["images"])
    np.testing.assert_array_equal(seqs, j_seqs)
    np.testing.assert_array_equal(lengths, j_len)


def test_fused_backbone_flag_encodes_eagerly(family):
    """``fused_backbone=True`` (the fixture's config) with a non-MobileNet
    backbone encodes eagerly in both packages (``supports_fused_backbone``):
    no packed backbone; the encode equal to JAX's is held by
    ``test_encode_and_beam_search_match_jax``."""
    assert family["cfg"].fused_backbone and family["jpipe"].config.fused_backbone
    assert not supports_fused_backbone(family["name"])
    assert not jx_supports_fused_backbone(family["name"])
    assert family["pipe"].backbone_packed is None


def test_entry_points_run_on_the_backbone(family, tmp_path):
    """The entry points over this backbone's pipeline: the CLI
    (``caption.main``) over the images as PNG files gives ``predict_batch``'s
    captions, ``evaluate_img`` the first one's, and ``sample_batch`` at
    temperature 0 the greedy decode of the same encode."""
    pipe, images = family["pipe"], family["images"]
    for i, a in enumerate(images):
        Image.fromarray(a).save(tmp_path / f"img{i}.png")
    cfg = family["cfg"].replace(decode_batch=2, result_dir=str(tmp_path / "results"))
    results = pt_caption.main(cfg, str(tmp_path), None, pipeline=pipe)
    seqs, lengths = pipe.predict_batch(images)
    captions = [pipe.to_caption(s, n) for s, n in zip(seqs, lengths)]
    assert [r["caption"] for r in sorted(results, key=lambda r: r["file"])] == captions
    assert pipe.evaluate_img(images[0]) == [{"image_id": 0, "caption": captions[0]}]
    sampled = pipe.sample_batch(images, seed=0, temperature=0.0)
    greedy = greedy_decode(pipe.transformer, pipe.encode(images), max_len=MAX_LEN,
                           start_token=pipe.start_token, end_token=pipe.end_token)
    for got, want in zip(sampled, greedy):
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("name", FAMILIES)
def test_weight_files_round_trip(name, tmp_path, monkeypatch):
    """The Flax msgpack file of the JAX ``Pipeline.save_weights`` loads into
    the port bitwise, and the port's ``save_weights`` file into the JAX
    ``load_weights`` bitwise (VGG's tree has no ``batch_stats``: an empty map
    in both packages' files). A training pipeline's ``TrainState`` with
    seeded Adam moments, count and step, written by the port, restores into
    the JAX ``TrainState`` layout and, written back from JAX's restore, into
    the port bitwise; a ``train_step`` with ``remat_encoder`` takes the plain
    training forward's loss (rtol 1e-6); ``finalize_batch_stats`` re-estimates
    every BatchNorm, and on VGG returns 0 and leaves the state untouched.
    Depth cut (``CUT``)."""
    cut_depth(monkeypatch, name)
    family = build_family(name, tmp_path)
    variables, pipe, jpipe = family["variables"], family["pipe"], family["jpipe"]
    want = flat(variables)
    jpath, ppath = tmp_path / "jax.msgpack", tmp_path / "port.msgpack"
    jpipe.save_weights(str(jpath))
    pipe.load_weights(str(jpath))
    back = flat(to_flax(pipe.transformer))
    assert back.keys() == want.keys()
    for k, v in want.items():
        assert back[k].tobytes() == v.tobytes(), k
    pipe.save_weights(str(ppath))
    jpipe.load_weights(str(ppath))
    got = flat({"params": jpipe.state.params, "batch_stats": jpipe.state.batch_stats})
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.asarray(got[k]).tobytes() == v.tobytes(), k
    for path in (jpath, ppath):
        assert (read_flax_msgpack(path)["batch_stats"] == {}) == name.startswith("vgg")

    trainer = Pipeline(family["cfg"].tokenizer_filename, MAX_LEN,
                       family["cfg"].replace(remat_encoder=True), variables, device="cpu",
                       checkpoint_path=str(tmp_path / "ckpt"))
    state = trainer.state_tree()
    rng = np.random.default_rng(5)
    adam = state["opt_state"]["1"]
    for k in ("m", "v", "vhat"):
        adam[k] = traverse_util.unflatten_dict(
            {p: rng.random(v.shape, np.float32) for p, v in flat(adam[k]).items()}, sep="/")
    adam["count"], state["step"] = np.array(3, np.int32), np.array(3, np.int32)
    trainer.load_state_tree(state)
    state = trainer.state_tree()
    tree = flat(state)
    write_flax_msgpack(tmp_path / "state.msgpack", state)
    params = jax.eval_shape(lambda: variables["params"])
    template = JxTrainState(params, variables.get("batch_stats", {}),
                            jax.eval_shape(jpipe.optimizer.init, params), 0)
    jstate = serialization.from_state_dict(
        template, serialization.msgpack_restore((tmp_path / "state.msgpack").read_bytes()))
    assert isinstance(jstate, JxTrainState) and int(jstate.step) == 3
    assert int(jstate.opt_state[1].count) == 3
    (tmp_path / "jstate.msgpack").write_bytes(serialization.to_bytes(jstate))
    trainer.load_state_tree(read_flax_msgpack(tmp_path / "jstate.msgpack"))
    got = flat(trainer.state_tree())
    assert got.keys() == tree.keys()
    for k, v in tree.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k

    # a train step with remat_encoder (dropout 0) takes the loss of the
    # plain training forward on the same weights
    caps = np.random.default_rng(6).integers(1, 20, (2, MAX_LEN)).astype(np.int32)
    t_caps = torch.as_tensor(caps).long()
    with torch.no_grad():
        logits, _ = trainer.state.model.forward_train(
            torch.as_tensor(family["images"][:2]), t_caps[:, :-1], create_masks(t_caps[:, :-1]))
    want_loss = float(losses.masked_sparse_ce(t_caps[:, 1:], logits))
    np.testing.assert_allclose(trainer.train_step(family["images"][:2], caps), want_loss,
                               rtol=1e-6)
    before = {k: v for k, v in tree.items() if k.startswith("batch_stats/")}
    n = trainer.finalize_batch_stats([family["images"][:2], family["images"][2:]])
    after = flat(to_flax(trainer.state.model)["batch_stats"])
    if name.startswith("vgg"):
        assert n == 0 and before == after == {}
    else:
        assert n == 1 and all(not np.array_equal(after[k[len("batch_stats/"):]], v)
                              for k, v in before.items())
    jpipe.close()


# ---------------------------------------------------------------------------
# one training step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_loss_and_gradients_match_jax(name, monkeypatch):
    """The training forward (BatchNorm in training mode, dropout 0) at 128²,
    batch 3, depth cut (every layer kind kept, widths as published): the
    loss within rtol 1e-5 of ``jax.value_and_grad``'s, the updated running
    statistics within rtol 1e-5, atol 1e-6, and every gradient by the method
    of tests/test_torch_train_step.py: per tensor ``‖Δ‖ ≤ 5e-2·(‖g_jax‖ +
    1e-3·max‖g‖)``, the median over tensors ≤ 5e-3 (float32 gradients through
    training-mode BatchNorm are that ill-conditioned in either package)."""
    cut_depth(monkeypatch, name)
    jtok = fit(JxTokenizer)
    vocab = len(jtok.index_word)
    model = Transformer(**MODEL, input_vocab_size=(SIZE // 16) ** 2,
                        target_vocab_size=vocab, max_seq_len=MAX_LEN, backbone_name=name)
    variables = seeded(to_flax(model), seed=7)
    model.load_state_dict(from_flax(variables), strict=True)
    rng = np.random.default_rng(8)
    imgs = rng.integers(0, 256, (3, SIZE, SIZE, 3), dtype=np.uint8)
    caps = rng.integers(1, vocab, (3, MAX_LEN)).astype(np.int32)
    caps[1, 5:] = 0

    jx = JxTransformer(**MODEL, input_vocab_size=(SIZE // 16) ** 2,
                       target_vocab_size=vocab, max_seq_len=MAX_LEN, backbone_name=name, rate=0.0)
    tar_inp, tar_real = jnp.asarray(caps[:, :-1]), jnp.asarray(caps[:, 1:])
    stats = {"batch_stats": variables["batch_stats"]} if "batch_stats" in variables else {}

    def loss_fn(params):
        (logits, _), mut = jx.apply({"params": params, **stats}, jnp.asarray(imgs), tar_inp,
                                    True, jx_masks(tar_inp), mutable=["batch_stats"])
        return jx_losses.masked_sparse_ce(tar_real, logits), mut.get("batch_stats", {})

    (want_loss, want_stats), want = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    want, want_stats = flat(want), flat(want_stats)

    t_caps = torch.as_tensor(caps).long()
    logits, _ = model.forward_train(torch.as_tensor(imgs), t_caps[:, :-1],
                                    create_masks(t_caps[:, :-1]))
    loss = losses.masked_sparse_ce(t_caps[:, 1:], logits)
    names = [n for n, _ in model.named_parameters()]
    # the empty P7 view's query and key projections are unused (JAX's
    # gradients for them are 0)
    grads = torch.autograd.grad(loss, list(model.parameters()), allow_unused=True)
    grads = {n: torch.zeros_like(p) if g is None else g
             for n, p, g in zip(names, model.parameters(), grads)}
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = flat(_flax_tree(model, grads.items())["params"])
    assert set(got) == set(want)
    gmax = max(np.linalg.norm(np.asarray(g)) for g in want.values())
    errs = []
    for k, w in want.items():
        w = np.asarray(w)
        err = np.linalg.norm(got[k] - w) / (np.linalg.norm(w) + 1e-3 * gmax)
        assert err <= 5e-2, (k, err)
        errs.append(err)
    assert np.median(errs) <= 5e-3, np.median(errs)
    stats = flat(to_flax(model)["batch_stats"])
    assert stats.keys() == want_stats.keys()
    for k, w in want_stats.items():
        np.testing.assert_allclose(stats[k], np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=k)
