"""The plain reference held to the PyTorch captioner at a tiny size on the
CPU, both in float32 on the same seeded weights: the encode, the decoder's
log-probabilities, the beam search, and three training steps with AMSGrad,
the per-variable clip and the same dropout masks. Card-only: none."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import TINY, tiny_files
from gpubench import harness, inputs
from gpubench.reference import decode as ref_decode
from gpubench.reference import model as ref_model

F32 = dict(compute_dtype="float32")


@pytest.fixture(scope="module")
def world():
    """The captioner's float32 pipeline and the reference on one state."""
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

    torch.set_num_threads(2)
    cfg = dict(tiny_files("mnv2.caption_b64")["config"], **F32)
    state = inputs.make_weights(cfg, 60, 11, "cpu", scales={"vocab": 8.0, "embedding": 20.0,
                                                            "trunk": 10.0})
    pipe = Pipeline(harness.tokenizer(60), 12, harness.program_config(cfg),
                    inputs.flax_tree(state, cfg, 60), device="cpu")
    ref = inputs.reference_model(cfg, 60, "cpu")
    ref.load_state_dict(state)
    images = inputs.images(3, 256, 12, "cpu")
    return pipe, ref.eval(), images


def test_encode(world):
    pipe, ref, images = world
    with torch.no_grad():
        want = ref.encode(torch.as_tensor(images))
    got = pipe.encode(images)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_teacher_forced_logits(world):
    from fpn_mt_image_captioning_torch.models.positional import create_look_ahead_mask

    pipe, ref, images = world
    tokens = torch.tensor([[2, 7, 9, 11, 4], [2, 5, 5, 40, 59], [2, 3, 0, 8, 1]])
    with torch.no_grad():
        enc = ref.encode(torch.as_tensor(images))
        want = ref.logits(enc, tokens)
        got, _ = pipe.transformer(enc, tokens, create_look_ahead_mask(5))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_beam_search(world):
    pipe, ref, images = world
    seqs, lengths = pipe.predict_batch(images)
    with torch.no_grad():
        best, _, _ = ref_decode.beam_search(ref, ref.encode(torch.as_tensor(images)), 4, 12, 2, 3)
    best = best[:, 0].numpy()
    for row, n, want in zip(seqs, lengths, best):
        want = list(want[: list(want).index(3)] if 3 in want else want)
        assert list(row[:n]) == want


def test_train_steps():
    """Three training steps of the captioner's training pipeline and of the
    reference from one state: losses, the first gradient, the parameters."""
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
    import tempfile

    torch.set_num_threads(2)
    cfg = dict(tiny_files("mnv2.train_b64")["config"], **F32)
    state = inputs.make_weights(cfg, 60, 13, "cpu")
    rng = np.random.default_rng(0)
    batches = [(inputs.images(4, 256, k, "cpu"), inputs.captions(4, 12, 60, (4, 12), rng))
               for k in range(3)]
    with tempfile.TemporaryDirectory() as tmp:
        pipe = Pipeline(harness.tokenizer(60), 12, harness.program_config(cfg, seed=21),
                        inputs.flax_tree(state, cfg, 60), device="cpu", checkpoint_path=tmp)
        losses = [pipe.train_step(*b) for b in batches]
        params = dict(inputs.leaves(pipe.state_tree()["params"]))
    from gpubench.reference import train as ref_train

    ref = inputs.reference_model(cfg, 60, "cpu")
    ref.load_state_dict(state)
    want = ref_train.train_steps(ref, [(torch.as_tensor(i), torch.as_tensor(c)) for i, c in batches],
                                 seed=21, dropout=cfg["dropout_rate"], d_lr=cfg["dff"],
                                 warmup=cfg["warm_up_steps"])
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    paths = inputs.flax_paths(cfg, 60)
    tree = inputs.flax_tree({k: v.detach() for k, v in ref.state_dict().items()}, cfg, 60)
    ref_params = dict(inputs.leaves(tree["params"]))
    for key in paths.values():
        np.testing.assert_allclose(params[key], ref_params[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)


def test_dropout_rule_matches():
    from fpn_mt_image_captioning_torch.models.layers import Dropout

    x = torch.randn(4, 5, 6)
    got = Dropout(0.1, 99, 3, torch.device("cpu"))(x, "decoder.layer_1.dropout2")
    want = ref_model.Dropout(0.1, 99, 3, "cpu")(x, "decoder.layer_1.dropout2")
    assert torch.equal(got, want)


def test_numerics_round_below_bfloat16():
    from gpubench.reference.numerics import NUMERICS

    x = torch.randn(1000)
    err = {k: float((f(x) - x).abs().max() / x.abs().max()) for k, f in NUMERICS.items()}
    assert err["float32"] == 0.0 < err["bfloat16"] < err["fp8"] < 0.1
    assert TINY["d_model"] == 32
