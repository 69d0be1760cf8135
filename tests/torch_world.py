"""One rank of a world of CPU processes for tests/test_torch_parallel_world.py.

    RANK=r WORLD_SIZE=n LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python tests/torch_world.py OUT_DIR INPUT_DIR MODEL_AXIS [seeded]

Every rank of the world runs the same checks in the same order (each a
sequence of collectives), over gloo, on one intra-op thread, and writes what
it saw to ``OUT_DIR/rank<r>.json``; rank 0 also writes the trees and arrays
that the test compares with one process and with the JAX package
(``OUT_DIR/*.msgpack``, ``*.npz``). ``INPUT_DIR`` holds what the test made
first: the decode weights of the beam-search check, a checkpoint of one
process, and a synthetic COCO split. The global batch of each check is
split over the ranks in rank order; the module imports no JAX (the test
imports the constants and data makers below).
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from fpn_mt_image_captioning_torch.config import Config, MeshConfig  # noqa: E402
from fpn_mt_image_captioning_torch.data.tokenizer import (REFERENCE_FILTERS,  # noqa: E402
                                                          Tokenizer)

SIZE, ENCODE_SIZE, MAX_LEN, GLOBAL_B, STEPS = 128, 200, 8, 4, 3
FIELDS = dict(image_input_size=SIZE, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
              num_heads=4, dff=64, compute_dtype="float32", beam_search_n=2, decode_batch=2,
              n_val_dataset=5)
# the fused beam search of tests/test_parallel.py:148-191 (enc (8, 4, 32))
BEAM_VOCAB, BEAM_START, BEAM_END, BEAM_MAX_LEN, BEAM_N, BEAM_ROWS = 23, 2, 3, 7, 4, 8
FINALIZE_ROWS = 2          # rows of each rank's batches in the finalize check
SAMPLE_SEED = 5


def tokenizer() -> Tokenizer:
    """A seeded corpus of 26 words: 30 tokens, so the vocabulary divides
    over a model axis of 2 and the final layer's rule engages."""
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(26)]
    tok = Tokenizer(num_words=5000, oov_token="unk", filters=REFERENCE_FILTERS)
    tok.fit_on_texts(["<start> " + " ".join(rng.choice(words, rng.integers(2, 7))) + " <end>"
                      for _ in range(80)])
    tok.add_padding_token()
    return tok


def config(dropout: float = 0.0, model_axis: int = 1, mesh: bool = True, **kw) -> Config:
    return Config(**{**FIELDS, **kw}, dropout_rate=dropout,
                  mesh=MeshConfig(enabled=mesh, model_axis_size=model_axis))


def train_batch(vocab: int):
    """The global batch of the step checks: 4 seeded uint8 images and
    captions, row 1 padded after 5 tokens, row 3 all padding (the
    zero-padded tail of a batch)."""
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (GLOBAL_B, SIZE, SIZE, 3), dtype=np.uint8)
    caps = rng.integers(1, vocab, (GLOBAL_B, MAX_LEN)).astype(np.int64)
    caps[1, 5:] = 0
    caps[3] = 0
    return images, caps


def finalize_batches(world: int):
    """Rank ``r``'s batches of the finalize check: ``3 + r`` batches of 2
    rows, so the ranks hold unequal counts; batch ``k`` of every rank
    together is global chunk ``k``."""
    rng = np.random.default_rng(11)
    pool = rng.integers(0, 256, (3 + world, world, FINALIZE_ROWS, SIZE, SIZE, 3),
                        dtype=np.uint8)
    return pool


def sample_inputs():
    rng = np.random.default_rng(13)
    images = rng.integers(0, 256, (GLOBAL_B, SIZE, SIZE, 3), dtype=np.uint8)
    return images, np.linspace(0.7, 1.3, GLOBAL_B).astype(np.float32)


def encode_images():
    return np.random.default_rng(17).integers(0, 256, (GLOBAL_B, ENCODE_SIZE, ENCODE_SIZE, 3),
                                              dtype=np.uint8)


def step_variables(tok) -> dict:
    """The start of the step checks: the ``{"params", "batch_stats"}`` tree
    of the model at these sizes, drawn from a generator seeded 0 with
    he_normal for every conv, dense and stacked projection kernel, zero
    biases, U(-0.05, 0.05) embeddings, unit norm scales and statistics (0,
    1), in module order. The port's ``init_weights`` draws the JAX package's
    families instead (lecun_normal backbones, glorot_uniform FPN and
    vocabulary layer, normal(0.01) head trunks); on those, three steps'
    Adam moments of every float32 route (the JAX package's, one process,
    the sharded step) lie ~1e-2 (median tensor) from a float64 witness
    (``tests/float64_witness.py``), so a bar between two float32 routes
    would measure rounding, not the sharded path. On these weights the
    routes agree within the checks' bars."""
    from fpn_mt_image_captioning_torch.models.attention import MultiViewAttention
    from fpn_mt_image_captioning_torch.models.layers import BatchNorm32, he_normal_
    from fpn_mt_image_captioning_torch.models.transformer import Encoder, Transformer
    from fpn_mt_image_captioning_torch.weights import to_flax

    cfg = config(mesh=False)
    with torch.device("meta"):
        model = Transformer(
            num_layers=cfg.num_layers, d_model=cfg.d_model, num_heads=cfg.num_heads,
            dff=cfg.dff, input_vocab_size=cfg.input_vocab_size,
            target_vocab_size=len(tok.index_word), max_seq_len=MAX_LEN,
            num_pyramids=cfg.num_of_pyramids, baseline_index=cfg.baseline_index,
            backbone_name=cfg.backbone, n_conv_submodule=cfg.n_conv_submodule,
            activation=cfg.activation, bn_momentum=cfg.bn_momentum,
            compute_dtype=torch.float32)
    model = model.to_empty(device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                he_normal_(m.weight, m.weight[0].numel(), g)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, torch.nn.Linear):
                he_normal_(m.weight, m.in_features, g)
                m.bias.zero_()
            elif isinstance(m, torch.nn.Embedding):
                m.weight.uniform_(-0.05, 0.05, generator=g)
            elif isinstance(m, (torch.nn.LayerNorm, BatchNorm32)):
                m.weight.fill_(1.0)
                m.bias.zero_()
                if isinstance(m, BatchNorm32):
                    m.running_mean.zero_()
                    m.running_var.fill_(1.0)
            elif isinstance(m, MultiViewAttention):
                for w in (m.wq, m.wo):
                    he_normal_(w, w.shape[-2], g)
                m.bq.zero_()
                m.bo.zero_()
            elif isinstance(m, Encoder):
                he_normal_(m.kv_proj, m.kv_proj.shape[-2], g)
                m.kv_bias.zero_()
    return to_flax(model)


def beam_model(variables):
    """The decoder of the beam-search check holding ``variables`` (the JAX
    package's decode-only init)."""
    from fpn_mt_image_captioning_torch.models.transformer import Transformer
    from fpn_mt_image_captioning_torch.weights import from_flax

    model = Transformer(2, 32, 4, 64, 16, BEAM_VOCAB, max_seq_len=BEAM_MAX_LEN + 1,
                        backbone_name="mobilenet224_0.35")
    missing, unexpected = model.load_state_dict(from_flax(variables), strict=False)
    assert not unexpected and all(k.startswith("encoder.") for k in missing), unexpected
    return model.eval()


def local_rows(a, rank: int, world: int):
    n = a.shape[0] // world
    return a[rank * n:(rank + 1) * n]


# ---------------------------------------------------------------------------
def main() -> None:
    out, inputs, model_axis = Path(sys.argv[1]), Path(sys.argv[2]), int(sys.argv[3])
    # "seeded": the step checks start from the port's seeded init instead
    seeded_start = sys.argv[4:] == ["seeded"]
    torch.set_num_threads(1)
    from fpn_mt_image_captioning_torch.parallel import mesh as pm
    from fpn_mt_image_captioning_torch.parallel import multihost as mh
    from fpn_mt_image_captioning_torch.parallel.train import (make_sharded_beam_search,
                                                              make_sharded_decode_encode)
    from fpn_mt_image_captioning_torch.train.checkpoint import CheckpointManager
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
    from fpn_mt_image_captioning_torch.train.schedule import clip_by_per_variable_norm_
    from fpn_mt_image_captioning_torch.weights import read_flax_msgpack, write_flax_msgpack

    assert mh.maybe_initialize("cpu") and mh.maybe_initialize("cpu")
    rank, world = mh.rank(), mh.world_size()
    primary = mh.is_primary()
    seen: dict = {"rank": rank, "world": world, "process_shard": list(mh.process_shard())}
    times: dict = {}
    tok = tokenizer()
    vocab = len(tok.index_word)
    assert vocab % 2 == 0, vocab
    t0 = time.perf_counter()

    def tick(name):
        nonlocal t0
        times[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    def same_on_all_ranks(name, value):
        got = mh.gather_rows(np.asarray([json.dumps(value, sort_keys=True)], object))
        assert len(set(got.tolist())) == 1, (name, got)

    # (1) the sharded step, dropout 0 and 0.1, with a zero-padded row
    images, caps = train_batch(vocab)
    pipes = {}
    for dropout in (0.0, 0.1):
        tag = f"step_dropout{dropout}"
        pipe = Pipeline(tok, MAX_LEN, config(dropout, model_axis),
                        None if seeded_start else step_variables(tok), seed=0,
                        device="cpu", checkpoint_path=str(out / f"ckpt_{tag}_{rank}"))
        assert pipe.mesh is not None and tuple(pipe.mesh.shape) == (world // model_axis,
                                                                   model_axis)
        losses = [pipe.train_step(local_rows(images, rank, world), local_rows(caps, rank, world))
                  for _ in range(STEPS)]
        seen[tag] = losses
        tree = pipe.state_tree()
        if primary:
            write_flax_msgpack(out / f"{tag}.msgpack", tree)
        seen[f"{tag}_placements"] = {k: v for k, v in pipe._placements.items()
                                     if v is not None}
        pipes[dropout] = pipe
    tick("steps")

    # (2) BatchNorm re-estimation over unequal local counts
    pool = finalize_batches(world)
    fresh = Pipeline(tok, MAX_LEN, config(0.0, model_axis), seed=0, device="cpu",
                     checkpoint_path=str(out / f"ckpt_finalize_{rank}"))
    seen["finalize_used"] = fresh.finalize_batch_stats(iter(pool[:3 + rank, rank]))
    tree = fresh.state_tree()
    if primary:
        write_flax_msgpack(out / "finalized.msgpack", tree["batch_stats"])
    same_on_all_ranks("finalize", float(sum(np.asarray(v).sum() for v in
                                            _leaves(tree["batch_stats"]))))
    tick("finalize")

    # (3) a checkpoint written by the world, restored by it; and one written
    # by one process, restored by the world
    pipe = pipes[0.0]
    ckpt = out / "ckpt_world"
    CheckpointManager(str(ckpt)).save(STEPS, pipe.state_tree())
    again = Pipeline(tok, MAX_LEN, config(0.0, model_axis), seed=1, device="cpu",
                     checkpoint_path=str(ckpt))
    if primary:
        write_flax_msgpack(out / "world_saved.msgpack", pipe.state_tree())
        write_flax_msgpack(out / "world_restored.msgpack", again.state_tree())
    else:
        pipe.state_tree(), again.state_tree()
    single = Pipeline(tok, MAX_LEN, config(0.0, model_axis), seed=1, device="cpu",
                      checkpoint_path=str(inputs / "ckpt_single"))
    tree = single.state_tree()
    if primary:
        write_flax_msgpack(out / "single_restored.msgpack", tree)
    tick("checkpoint")

    # (4) the per-variable clip of a tensor-parallel variable
    rng = np.random.default_rng(19)
    g = torch.tensor(rng.standard_normal((4, 6)) * 3, dtype=torch.float32)
    r = torch.tensor(rng.standard_normal(5) * 0.01, dtype=torch.float32)
    mg = pm.model_group(pipe.mesh)
    n = 6 // model_axis
    i = pm.axis_index(pipe.mesh, 1)
    grads = [g[:, i * n:(i + 1) * n].clone(), r.clone()]
    clip_by_per_variable_norm_(grads, 1.0, [model_axis > 1, False], mg)
    from fpn_mt_image_captioning_torch.parallel.collectives import gather_shards

    clipped = [gather_shards(grads[0], mg, 1), grads[1]]
    if primary:
        np.savez(out / "clip.npz", g=g.numpy(), r=r.numpy(), g_clipped=clipped[0].numpy(),
                 r_clipped=clipped[1].numpy())
    del pipes, pipe, again, single
    tick("clip")

    # (5) the sharded fused beam search (float32 packing) and encode at 200²
    enc = torch.as_tensor(np.load(inputs / "beam_enc.npy"))
    model = beam_model(read_flax_msgpack(inputs / "beam_variables.msgpack"))
    mesh = pm.make_mesh(MeshConfig(model_axis_size=model_axis), "cpu")
    run = make_sharded_beam_search(mesh, model, beam_n=BEAM_N, max_len=BEAM_MAX_LEN,
                                   start_token=BEAM_START, end_token=BEAM_END, fused=True,
                                   pack_dtype=torch.float32)
    seqs, lengths, _ = run(local_rows(enc, rank, world))
    seqs, lengths = mh.gather_rows(seqs.numpy()), mh.gather_rows(lengths.numpy())
    inference = Pipeline(tok, MAX_LEN, config(0.0, model_axis, image_input_size=ENCODE_SIZE),
                         seed=0, device="cpu")
    encoded = make_sharded_decode_encode(mesh, inference.transformer)(
        torch.as_tensor(local_rows(encode_images(), rank, world)))
    encoded = mh.gather_rows(encoded.numpy())
    if primary:
        np.savez(out / "beam_encode.npz", seqs=seqs, lengths=lengths, encoded=encoded)
    tick("beam_encode")

    # (6) sampling and evaluation on an inference pipeline of seeded weights
    pipe = Pipeline(tok, MAX_LEN, config(0.0, model_axis), seed=0, device="cpu")
    images, temps = sample_inputs()
    s, l = pipe.sample_batch(local_rows(images, rank, world), seed=SAMPLE_SEED,
                             temperature=local_rows(temps, rank, world), top_p=0.95)
    p, pl = pipe.predict_batch(local_rows(images, rank, world))
    from fpn_mt_image_captioning_torch.data.dataset import COCO_Images_ImageID

    val = COCO_Images_ImageID(str(inputs / "data"), "val2017", FIELDS["n_val_dataset"],
                              image_size=SIZE, shard_count=world, shard_index=rank)
    seen["val_shard"] = [int(x) for x in val.imgIds]
    results = pipe.evaluate(iter(val))
    same_on_all_ranks("evaluate", results)
    gathered = {k: mh.gather_rows(v) for k, v in
                (("sample_seqs", s), ("sample_lengths", l), ("predict_seqs", p),
                 ("predict_lengths", pl))}
    if primary:
        np.savez(out / "decode.npz", **gathered)
        (out / "evaluate.json").write_text(json.dumps(results))
    tick("sample_evaluate")

    # (7) the train main (2 × 1 world): one writer, equal disjoint shards
    if model_axis == 1:
        train_main_check(out, inputs, rank, seen)
        tick("train_main")
    seen["seconds"] = times
    (out / f"rank{rank}.json").write_text(json.dumps(seen))
    mh.barrier("done")
    torch.distributed.destroy_process_group()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def train_main_check(out: Path, inputs: Path, rank: int, seen: dict) -> None:
    import contextlib
    import io

    from fpn_mt_image_captioning_torch.data.dataset import get_coco_images_dataset
    from fpn_mt_image_captioning_torch.train.__main__ import main as train_main

    from fpn_mt_image_captioning_torch.data.metrics import MetricEval

    root = out / "train_main"
    root.mkdir(exist_ok=True)
    # CIDEr plus the epoch number: epoch 2 improves, so a checkpoint is saved
    real, scored = MetricEval.__call__, []
    MetricEval.__call__ = lambda self, path: scored.append(real(self, path)) or \
        scored[-1] + len(scored)
    cfg = Config(**{**FIELDS, "n_val_dataset": 3}, datadir=str(inputs / "data"), epochs=2,
                 batch_size=2, n_epoch_to_evaluate=1, bn_finalize_batches=1,
                 mesh=MeshConfig(enabled=True), tokenizer_filename=str(root / "tok.json"),
                 additional_filename=str(root / "info.json"),
                 transformer_checkpoint_path=str(root / "ckpt"),
                 transformer_weight_path=str(root / "weights.msgpack"),
                 result_dir=str(root / "results"))
    with contextlib.chdir(root), contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        master = train_main(cfg, device="cpu")
    seen["train_main_losses"] = master.train_loss_history
    dataset, _, _ = get_coco_images_dataset(cfg.datadir, cfg.datatype_train, config=cfg)
    seen["train_main_shard"] = [os.path.basename(p) for p in dataset.img_paths]
    seen["train_main_ckpt_steps"] = master.ckpt_manager.all_steps()
    seen["train_main_logs"] = sorted(os.listdir(root / "logs" / "transformer"))
    seen["train_main_files"] = sorted(os.listdir(root / "results"))


if __name__ == "__main__":
    main()
