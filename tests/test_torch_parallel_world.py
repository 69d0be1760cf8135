"""The port over worlds of ranks on the CPU, against one process and the JAX
package: a world of 2 ranks (mesh 2 × 1) and one of 4 (2 × 2), each spawned
once for the module (``tests/torch_world.py``: gloo, one intra-op thread a
rank, a timeout of 300 s a world). Each rank runs every check in the same
order; this process computes the single-process and JAX references while the
worlds run, and each case below compares one check. Sizes: 128²,
mobilenet224_0.35, d 32, 2+2 layers, 4 heads, dff 64, a vocabulary of 30
(every tensor-parallel rule divides over a model axis of 2), float32; the
global batch of a step is 4 rows, row 3 all padding. Tolerances are stated
where they are used."""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import torch_world as tw
from fixtures import make_synthetic_dataset
from fpn_mt_image_captioning_tpu.config import Config as JxConfig
from fpn_mt_image_captioning_tpu.config import MeshConfig as JxMeshConfig
from fpn_mt_image_captioning_tpu.models.transformer import Transformer as JxTransformer
from fpn_mt_image_captioning_tpu.parallel.mesh import make_mesh as jx_make_mesh
from fpn_mt_image_captioning_tpu.train.pipeline import TrainState as JxTrainState
from fpn_mt_image_captioning_tpu.train.pipeline import build_train_step_fn as jx_step_fn
from fpn_mt_image_captioning_tpu.train.schedule import custom_schedule, make_optimizer
from fpn_mt_image_captioning_torch.data.dataset import COCO_Images_ImageID
from fpn_mt_image_captioning_torch.decode.beam_search import beam_search
from fpn_mt_image_captioning_torch.ops.fused_decoder import pack_decoder_weights
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
from fpn_mt_image_captioning_torch.train.schedule import clip_by_per_variable_norm_
from fpn_mt_image_captioning_torch.weights import read_flax_msgpack, to_flax, write_flax_msgpack

WORLDS = {"2x1": (2, 1), "2x2": (4, 2)}
WORKER = Path(__file__).with_name("torch_world.py")
TIMEOUT_S = 300


def flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in
            traverse_util.flatten_dict(jax.device_get(tree), sep="/").items()}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread here too (restored after), as the ranks run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tok():
    return tw.tokenizer()


@pytest.fixture(scope="module")
def inputs(tmp_path_factory, tok):
    """What the ranks read: the JAX package's decode-only init of the beam
    check (as tests/test_parallel.py makes it) and its encoder output, a
    checkpoint written by one process after two steps, a synthetic split."""
    d = tmp_path_factory.mktemp("world_inputs")
    key = jax.random.PRNGKey(7)
    model = JxTransformer(num_layers=2, d_model=32, num_heads=4, dff=64, input_vocab_size=16,
                          target_vocab_size=tw.BEAM_VOCAB, max_seq_len=tw.BEAM_MAX_LEN + 1)
    enc = jax.random.normal(key, (tw.BEAM_ROWS, 4, 32))
    variables = model.init({"params": key, "dropout": key}, enc[:2],
                           jnp.ones((2, 4), jnp.int32), False, None)
    write_flax_msgpack(d / "beam_variables.msgpack", jax.tree.map(np.asarray, variables))
    np.save(d / "beam_enc.npy", np.asarray(enc))
    pipe = Pipeline(tok, tw.MAX_LEN, tw.config(mesh=False), seed=2, device="cpu",
                    checkpoint_path=str(d / "ckpt_single"))
    images, caps = tw.train_batch(len(tok.index_word))
    for _ in range(2):
        pipe.train_step(images, caps)
    pipe.ckpt_manager.save(2, pipe.state_tree())
    make_synthetic_dataset(str(d / "data"), n_train=6, n_val=5, image_size=tw.SIZE)
    return dict(dir=d, model=model, variables=variables, enc=enc)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """The ranks of one world, started at once; ``result()`` waits for them
    (at most ``TIMEOUT_S`` from the start; on expiry they are killed and the
    case fails) and reads what they wrote."""

    def __init__(self, name: str, root: Path, inputs: Path):
        self.name, self.out = name, root / name
        self.out.mkdir(parents=True)
        n, m = WORLDS[name]
        port = free_port()
        self.start = time.perf_counter()
        self.procs = []
        for r in range(n):
            env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(n), "LOCAL_RANK": "0",
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                   "OMP_NUM_THREADS": "1"}
            log = open(self.out / f"log{r}.txt", "w")
            self.procs.append(subprocess.Popen(
                [sys.executable, str(WORKER), str(self.out), str(inputs), str(m)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
        self._ranks = None

    def result(self) -> list[dict]:
        if self._ranks is None:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, TIMEOUT_S - (time.perf_counter() - self.start)))
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"world {self.name}: no end within {TIMEOUT_S} s")
            codes = [p.returncode for p in self.procs]
            if any(codes):
                logs = "".join((self.out / f"log{r}.txt").read_text()[-3000:]
                               for r, c in enumerate(codes) if c)
                pytest.fail(f"world {self.name}: exit codes {codes}\n{logs}")
            self.seconds = time.perf_counter() - self.start
            self._ranks = [json.loads((self.out / f"rank{r}.json").read_text())
                           for r in range(len(self.procs))]
        return self._ranks

    def tree(self, name: str) -> dict:
        self.result()
        return read_flax_msgpack(self.out / f"{name}.msgpack")

    def arrays(self, name: str):
        self.result()
        return np.load(self.out / f"{name}.npz")

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    root = tmp_path_factory.mktemp("worlds")
    started = {name: World(name, root, inputs["dir"]) for name in WORLDS}
    yield started
    for w in started.values():
        w.kill()
    secs = {n: round(getattr(w, "seconds", float("nan")), 1) for n, w in started.items()}
    print(f"\n[test_torch_parallel_world] worker seconds: {secs}")


# ---------------------------------------------------------------------------
# single-process references (the port and the JAX package)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def one_process(worlds, tok, tmp_path_factory):
    """The port in one process on the global batches: the 3 steps at
    dropout 0 and 0.1, then BatchNorm re-estimation over the global chunks
    of the finalize check."""
    root = tmp_path_factory.mktemp("one_process")
    vocab = len(tok.index_word)
    images, caps = tw.train_batch(vocab)
    out = {}
    for dropout in (0.0, 0.1):
        pipe = Pipeline(tok, tw.MAX_LEN, tw.config(dropout, mesh=False), seed=0, device="cpu",
                        checkpoint_path=str(root / f"ckpt{dropout}"))
        losses = [pipe.train_step(images, caps) for _ in range(tw.STEPS)]
        out[dropout] = dict(losses=losses, tree=pipe.state_tree(), pipe=pipe)
    return out


def finalized_one_process(pipe, world: int) -> dict:
    """``pipe`` re-estimated over the finalize check's global chunks (chunk
    ``k``: batch ``k`` of every rank, in rank order; 3 chunks, the fewest
    any rank holds)."""
    pool = tw.finalize_batches(world)
    used = pipe.finalize_batch_stats(iter(pool[:3].reshape(3, -1, tw.SIZE, tw.SIZE, 3)))
    assert used == 3
    return flat(pipe.state_tree()["batch_stats"])


@pytest.fixture(scope="module")
def jax_steps(worlds, tok):
    """The JAX package's single-device step (``build_train_step_fn``,
    jitted) from the port's seeded weights, 3 steps on the global batch,
    dropout 0, the same schedule (warm-up 4000)."""
    jcfg = JxConfig(**tw.FIELDS, dropout_rate=0.0)
    vocab = len(tok.index_word)
    model = JxTransformer(
        num_layers=jcfg.num_layers, d_model=jcfg.d_model, num_heads=jcfg.num_heads,
        dff=jcfg.dff, input_vocab_size=jcfg.input_vocab_size, target_vocab_size=vocab,
        rate=0.0, max_seq_len=tw.MAX_LEN, num_pyramids=jcfg.num_of_pyramids,
        baseline_index=jcfg.baseline_index, backbone_name=jcfg.backbone,
        n_conv_submodule=jcfg.n_conv_submodule, activation=jcfg.activation,
        bn_momentum=jcfg.bn_momentum)
    start = Pipeline(tok, tw.MAX_LEN, tw.config(mesh=False), seed=0, device="cpu")
    variables = to_flax(start.transformer)
    optimizer = make_optimizer(custom_schedule(
        jcfg.dff if jcfg.schedule_uses_dff else jcfg.d_model, jcfg.warm_up_steps))
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JxTrainState(params, jax.tree.map(jnp.asarray, variables["batch_stats"]),
                         optimizer.init(params), jnp.int32(0))
    step = jax.jit(jx_step_fn(model, optimizer, jcfg.seed))
    images, caps = tw.train_batch(vocab)
    losses = []
    for _ in range(tw.STEPS):
        state, loss = step(state, jnp.asarray(images), jnp.asarray(caps, jnp.int32))
        losses.append(float(loss))
    return dict(losses=losses, params=flat(state.params), batch_stats=flat(state.batch_stats),
                m=flat(state.opt_state[1].m))


def assert_gradients_close(got: dict, want: dict) -> None:
    """Adam's first moments (sums of the clipped gradients of the 3 steps)
    held as tests/test_torch_train_step.py holds the gradients of the two
    packages: per tensor ``‖Δ‖ ≤ 5e-2·(‖w‖ + 1e-3·max‖w‖)``, the median
    over tensors ≤ 5e-3 (training-mode BatchNorm makes float32 gradients
    that ill-conditioned; a sum over ranks rounds otherwise than one pass)."""
    assert got.keys() == want.keys()
    gmax = max(np.linalg.norm(w) for w in want.values())
    errs = {k: np.linalg.norm(got[k] - w) / (np.linalg.norm(w) + 1e-3 * gmax)
            for k, w in want.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 5e-2, (worst, errs[worst])
    assert np.median(list(errs.values())) <= 5e-3, np.median(list(errs.values()))


def assert_step_close(ranks, tree, losses, params, stats, m):
    """The bar of tests/test_parallel.py:141-145 on every step: the loss
    within rtol 1e-5 (every rank reports the same global loss) and every
    parameter within atol 2e-5; the BatchNorm running statistics within
    rtol 1e-5, atol 1e-6; Adam's moments as ``assert_gradients_close``."""
    for seen in ranks:
        np.testing.assert_allclose(seen["got"], losses, rtol=1e-5)
    got = flat(tree["params"])
    assert got.keys() == params.keys()
    for k, w in params.items():
        np.testing.assert_allclose(got[k], w, atol=2e-5, rtol=0, err_msg=k)
    got = flat(tree["batch_stats"])
    for k, w in stats.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6, err_msg=k)
    assert_gradients_close(flat(tree["opt_state"]["1"]["m"]), m)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(WORLDS))
def test_sharded_step_matches_jax_single_device(name, worlds, jax_steps):
    """Dropout 0: the 3 sharded steps (a zero-padded row on the second data
    share) against the JAX package's single-device step."""
    w = worlds[name]
    ranks = [{"got": r["step_dropout0.0"]} for r in w.result()]
    assert_step_close(ranks, w.tree("step_dropout0.0"), jax_steps["losses"],
                      jax_steps["params"], jax_steps["batch_stats"], jax_steps["m"])


@pytest.mark.parametrize("name", list(WORLDS))
def test_sharded_step_with_dropout_matches_one_process(name, worlds, one_process):
    """Dropout 0.1 (its bits are the port's, not JAX's threefry): the
    sharded steps against the port's single-process step on the global
    batch, at the same bar; the masks of the global batch, so the mesh
    changes none."""
    w = worlds[name]
    ref = one_process[0.1]
    want = flat(ref["tree"])
    ranks = [{"got": r["step_dropout0.1"]} for r in w.result()]
    assert_step_close(ranks, w.tree("step_dropout0.1"), ref["losses"],
                      {k[len("params/"):]: v for k, v in want.items()
                       if k.startswith("params/")},
                      {k[len("batch_stats/"):]: v for k, v in want.items()
                       if k.startswith("batch_stats/")},
                      flat(ref["tree"]["opt_state"]["1"]["m"]))


def test_tensor_parallel_rules_engage(worlds):
    """On the 2 × 2 mesh every rule of the JAX package shards its parameter
    (each dimension divides), on the dimension of the port's layout; on
    2 × 1 nothing is sharded."""
    placed = worlds["2x2"].result()[0]["step_dropout0.0_placements"]
    assert placed["encoder.kv_proj"] == 3 and placed["encoder.layer_0.mva.wo"] == 1
    assert placed["decoder.layer_1.mha2.wq.weight"] == 0       # (out, in): column
    assert placed["decoder.layer_1.mha2.out.weight"] == 1      # row
    assert placed["final_layer.weight"] == 0 and placed["final_layer.bias"] == 0
    assert not any("feature_extractor" in k or "layernorm" in k for k in placed)
    # per encoder layer mva wq/bq/wo and ffn1 w/b, ffn2 w; the K/V stack;
    # per decoder layer q/k/v w/b and out w of two attentions and its FFN's 3
    assert len(placed) == 2 * 6 + 2 + 2 * (2 * 7 + 3) + 2
    assert worlds["2x1"].result()[0]["step_dropout0.0_placements"] == {}


@pytest.mark.parametrize("name", list(WORLDS))
def test_finalize_batch_stats_aligns_counts(name, worlds, tok, tmp_path):
    """Rank ``r`` holds ``3 + r`` batches: every rank re-estimates over 3
    global chunks (the smallest count), and the statistics equal one
    process's over the same global chunks: each variance within rtol 5e-5,
    atol 1e-6 (E[x²] − E[x]² deep in the backbone, after the moments of the
    earlier blocks were summed over ranks in another order: 1.3e-5
    measured), each mean within 1e-5 of its channel's standard deviation
    (a BatchNorm fed by a normalized layer through a bias-free conv has a
    mean of zero up to rounding, ~1e-6 either way). Both start from the
    same seeded weights."""
    w = worlds[name]
    n = WORLDS[name][0]
    assert [r["finalize_used"] for r in w.result()] == [3] * n
    pipe = Pipeline(tok, tw.MAX_LEN, tw.config(mesh=False), seed=0, device="cpu",
                    checkpoint_path=str(tmp_path / "ckpt"))
    want = finalized_one_process(pipe, n)
    got = flat(w.tree("finalized"))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k.endswith("/mean"):
            std = np.sqrt(want[k[:-len("mean")] + "var"])
            assert (np.abs(got[k] - v) <= 1e-5 * std).all(), k
        else:
            np.testing.assert_allclose(got[k], v, rtol=5e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", list(WORLDS))
def test_per_variable_clip_of_a_sharded_variable(name, worlds):
    """A (4, 6) gradient of norm > 1 split over the model axis and a small
    replicated one: clipped by the whole variable's norm, gathered, equal to
    one process's clip (rtol 1e-6)."""
    a = worlds[name].arrays("clip")
    grads = [torch.tensor(a["g"]), torch.tensor(a["r"])]
    clip_by_per_variable_norm_(grads, 1.0)
    np.testing.assert_allclose(a["g_clipped"], grads[0].numpy(), rtol=1e-6)
    np.testing.assert_array_equal(a["r_clipped"], grads[1].numpy())
    assert abs(np.linalg.norm(a["g_clipped"]) - 1.0) < 1e-6


@pytest.fixture(scope="module")
def jax_beams(worlds, inputs):
    """The JAX package's ``make_sharded_beam_search`` (fused, float32
    packing, the kernel in interpret mode) on its (8, 1) and (4, 2) virtual
    meshes, as tests/test_parallel.py:148-191 runs it."""
    from jax.experimental.pallas import tpu as pltpu

    from fpn_mt_image_captioning_tpu.parallel.train import make_sharded_beam_search

    out = {}
    for shape in ((8, 1), (4, 2)):
        mesh = jx_make_mesh(JxMeshConfig(data_axis_size=shape[0], model_axis_size=shape[1]))
        with pltpu.force_tpu_interpret_mode():
            run = make_sharded_beam_search(
                mesh, inputs["model"], beam_n=tw.BEAM_N, max_len=tw.BEAM_MAX_LEN,
                start_token=tw.BEAM_START, end_token=tw.BEAM_END, fused=True,
                pack_dtype=jnp.float32)
            seqs, lengths, _ = run(inputs["variables"], inputs["enc"])
        out[shape] = np.asarray(seqs), np.asarray(lengths)
    return out


@pytest.mark.parametrize("name", list(WORLDS))
def test_sharded_fused_beam_search_is_bitwise(name, worlds, inputs, jax_beams):
    """The sharded fused beam search (each rank its rows, whole weights,
    float32 packing) equals the port's unsharded search and the JAX
    package's sharded search on (8, 1) and (4, 2), bitwise."""
    a = worlds[name].arrays("beam_encode")
    model = tw.beam_model(read_flax_msgpack(inputs["dir"] / "beam_variables.msgpack"))
    seqs, lengths, _ = beam_search(model, torch.as_tensor(np.load(inputs["dir"] /
                                                                  "beam_enc.npy")),
                                   beam_n=tw.BEAM_N, max_len=tw.BEAM_MAX_LEN,
                                   start_token=tw.BEAM_START, end_token=tw.BEAM_END,
                                   fused=True, packed=pack_decoder_weights(model, torch.float32))
    np.testing.assert_array_equal(a["seqs"], seqs.numpy())
    np.testing.assert_array_equal(a["lengths"], lengths.numpy())
    for js, jl in jax_beams.values():
        np.testing.assert_array_equal(a["seqs"], js)
        np.testing.assert_array_equal(a["lengths"], jl)


@pytest.mark.parametrize("name", list(WORLDS))
def test_sharded_encode_at_200(name, worlds, tok):
    """The sharded encode at 200² (a size that is no power of two): each
    rank's rows equal one process's encode of the batch within atol 3e-5
    (the LayerNorm'd output is O(1); the CPU convolutions round by batch
    size, and a rank of the 2 × 2 world encodes 1 row where one process
    encodes 4: 1.0e-5 measured), and the JAX package's encode of the same
    weights within atol 1e-4 (seeded weights with the initial BatchNorm
    statistics grow the backbone's activations, so float32 rounding differs
    more than with calibrated ones: 6.0e-5 measured)."""
    got = worlds[name].arrays("beam_encode")["encoded"]
    pipe = Pipeline(tok, tw.MAX_LEN, tw.config(mesh=False, image_input_size=tw.ENCODE_SIZE),
                    seed=0, device="cpu")
    images = tw.encode_images()
    want = pipe.encode(images).numpy()
    assert got.shape == want.shape and got.shape[0] == tw.GLOBAL_B
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=0)
    jcfg = JxConfig(**{**tw.FIELDS, "image_input_size": tw.ENCODE_SIZE})
    model = JxTransformer(num_layers=2, d_model=32, num_heads=4, dff=64,
                          input_vocab_size=jcfg.input_vocab_size,
                          target_vocab_size=len(tok.index_word), max_seq_len=tw.MAX_LEN,
                          backbone_name=jcfg.backbone)
    jx = model.apply(jax.tree.map(jnp.asarray, to_flax(pipe.transformer)), jnp.asarray(images),
                     method=JxTransformer.encode)
    np.testing.assert_allclose(got, np.asarray(jx), atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", list(WORLDS))
def test_sharded_sample_and_predict_equal_one_process(name, worlds, tok):
    """``sample_batch`` (per-row temperatures, top-p 0.95) and
    ``predict_batch`` of each rank's rows, gathered, equal one process's on
    the whole batch: the Gumbel noise is drawn for the global rows."""
    a = worlds[name].arrays("decode")
    pipe = Pipeline(tok, tw.MAX_LEN, tw.config(mesh=False), seed=0, device="cpu")
    images, temps = tw.sample_inputs()
    s, l = pipe.sample_batch(images, seed=tw.SAMPLE_SEED, temperature=temps, top_p=0.95)
    p, pl = pipe.predict_batch(images)
    np.testing.assert_array_equal(a["sample_seqs"], s)
    np.testing.assert_array_equal(a["sample_lengths"], l)
    np.testing.assert_array_equal(a["predict_seqs"], p)
    np.testing.assert_array_equal(a["predict_lengths"], pl)
    assert len({tuple(r) for r in s}) > 1     # the noise drives the draws


@pytest.mark.parametrize("name", list(WORLDS))
def test_evaluate_over_ranks_equals_one_process(name, worlds, tok, inputs):
    """Each rank evaluates its shard of 5 validation images (shards of
    unequal length: lock step with batches of zeros); every rank returns
    the same global list, which equals one process's, image by image. The
    shards are disjoint and cover the split (seed 0 by default when
    sharded)."""
    w = worlds[name]
    ranks = w.result()
    assert [r["process_shard"] for r in ranks] == [[i, len(ranks)] for i in range(len(ranks))]
    got = json.loads((w.out / "evaluate.json").read_text())
    pipe = Pipeline(tok, tw.MAX_LEN, tw.config(mesh=False), seed=0, device="cpu")
    val = COCO_Images_ImageID(str(inputs["dir"] / "data"), "val2017",
                              tw.FIELDS["n_val_dataset"], image_size=tw.SIZE, seed=0)
    want = pipe.evaluate(iter(val))
    shards = [r["val_shard"] for r in ranks]
    assert sorted(sum(shards, [])) == sorted(val.imgIds)
    assert [d["image_id"] for d in got] == sum(shards, [])
    assert {d["image_id"]: d["caption"] for d in got} == \
        {d["image_id"]: d["caption"] for d in want}


@pytest.mark.parametrize("name", list(WORLDS))
def test_checkpoints_cross_worlds(name, worlds, tok, inputs, tmp_path):
    """A checkpoint the world wrote (its shards gathered, the primary
    writing) restores in one process and in the world to the saved state,
    bitwise; one written by one process restores in the world bitwise."""
    w = worlds[name]
    saved = flat(w.tree("world_saved"))
    for tree in (w.tree("world_restored"),
                 Pipeline(tok, tw.MAX_LEN, tw.config(mesh=False), seed=1, device="cpu",
                          checkpoint_path=str(w.out / "ckpt_world")).state_tree()):
        got = flat(tree)
        assert got.keys() == saved.keys()
        for k, v in saved.items():
            assert got[k].tobytes() == v.tobytes(), k
    single = Pipeline(tok, tw.MAX_LEN, tw.config(mesh=False), seed=1, device="cpu",
                      checkpoint_path=str(inputs["dir"] / "ckpt_single"))
    want, got = flat(single.state_tree()), flat(w.tree("single_restored"))
    assert int(want["step"]) == 2 and got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].tobytes() == v.tobytes(), k


def test_train_main_over_two_ranks(worlds):
    """``train``'s main on the 2 × 1 world over a synthetic split of 6
    training images (batches of 2) for 2 epochs with an evaluation each:
    both ranks report the same loss at every step, their corpus shards are
    disjoint and of equal length, and one rank wrote the logs, the result
    file and the checkpoint series (epoch 2's, which CIDEr + epoch made
    better)."""
    ranks = worlds["2x1"].result()
    losses = [r["train_main_losses"] for r in ranks]
    assert len(losses[0]) == 2 * 2 and losses[0] == losses[1]
    assert all(np.isfinite(losses[0]))
    shards = [set(r["train_main_shard"]) for r in ranks]
    assert len(shards[0]) == len(shards[1]) == 3 and not shards[0] & shards[1]
    for r in ranks:
        assert r["train_main_ckpt_steps"] == [2]
        assert len(r["train_main_logs"]) == 1
        assert r["train_main_files"] == ranks[0]["train_main_files"] and \
            len(r["train_main_files"]) == 1
