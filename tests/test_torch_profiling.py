"""The port's profiling module (``fpn_mt_image_captioning_torch/utils/
profiling.py``) on the CPU: ``StepTracer`` with the semantics of the JAX
package's (``tests/test_aux_components.py``: a trace over the step window,
an idempotent ``close``, a run with fewer steps than the window), ``trace``
and ``annotate``, ``sync``, and ``build_train_run`` / ``train_step_slope``
on a small float32 model (n steps of the runner equal n calls of the train
step; the loss sum is its output)."""

import copy
import glob
import json

import numpy as np
import pytest
import torch

from fpn_mt_image_captioning_torch.config import Config
from fpn_mt_image_captioning_torch.data.tokenizer import REFERENCE_FILTERS, Tokenizer
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline, build_train_step_fn
from fpn_mt_image_captioning_torch.train.schedule import custom_schedule
from fpn_mt_image_captioning_torch.utils.profiling import (StepTracer, annotate,
                                                           build_train_run, sync, trace,
                                                           train_step_slope)

CFG = Config(image_input_size=256, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
             num_heads=4, dff=64, compute_dtype="float32")
MAX_LEN, BATCH = 6, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (see
    tests/test_torch_backbones.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def traces(logdir) -> list[str]:
    return glob.glob(f"{logdir}/*.pt.trace.json")


def test_step_tracer_captures_window(tmp_path):
    """The trace opens at ``start``, closes at ``stop`` and is written then:
    it holds the ops of steps 1 and 2 and none of steps 0, 3 and 4;
    ``close()`` is idempotent; with fewer steps than the window, ``close()``
    ends the open trace and writes it."""
    logdir = tmp_path / "profile"
    tracer = StepTracer(str(logdir), start=1, stop=3)
    x = torch.ones((8, 8))
    for i in range(5):
        tracer.step(i)
        with annotate(f"step{i}"):
            x @ x
        if i == 2:
            assert not traces(logdir)   # still open
    tracer.close()
    tracer.close()
    [path] = traces(logdir)
    names = {e.get("name") for e in json.loads(open(path).read())["traceEvents"]}
    assert {"step1", "step2"} <= names and not names & {"step0", "step3", "step4"}

    tracer2 = StepTracer(str(tmp_path / "p2"), start=0, stop=10)
    tracer2.step(0)
    x @ x
    tracer2.close()
    assert len(traces(tmp_path / "p2")) == 1


def test_trace_and_annotate(tmp_path):
    with trace(str(tmp_path / "t")) as logdir:
        with annotate("span"):
            torch.ones(4).sum()
    [path] = traces(logdir)
    events = json.loads(open(path).read())["traceEvents"]
    assert any(e.get("name") == "span" and e.get("cat") == "user_annotation" for e in events)
    with annotate("outside a trace"):   # a span without a trace is a no-op
        pass


def test_sync_on_the_cpu_is_a_noop(monkeypatch):
    called = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: called.append(a))
    sync({"a": torch.ones(2), "b": [torch.zeros(1), (3, None)]})
    sync(None)
    assert called == []


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(0)
    words = [f"w{i}" for i in range(20)]
    tok = Tokenizer(num_words=CFG.top_k, oov_token="unk", filters=REFERENCE_FILTERS)
    tok.fit_on_texts(["<start> " + " ".join(rng.choice(words, 4)) + " <end>"
                      for _ in range(20)])
    tok.add_padding_token()
    pipe = Pipeline(tok, MAX_LEN, CFG, seed=0, device="cpu")
    return pipe.transformer.train(), len(tok.index_word)


def test_build_train_run_is_n_steps(model):
    """``run(state, img, caps, n)`` takes n steps of the production train
    step: the weights after it equal n calls of ``build_train_step_fn``'s
    step from the same weights, bitwise, and it returns the sum of their
    losses."""
    net, vocab = model
    a, b = copy.deepcopy(net), copy.deepcopy(net)
    kw = dict(batch=BATCH, seq_len=MAX_LEN, image_size=CFG.image_input_size, vocab=vocab)
    run, state, img, caps = build_train_run(a, **kw)
    assert img.shape == (BATCH, 256, 256, 3) and caps.shape == (BATCH, MAX_LEN)
    state, loss_sum = run(state, img, caps, 2)
    assert state.step == 2
    _, ref_state, _, _ = build_train_run(b, **kw)
    step = build_train_step_fn(custom_schedule(2048, 4000), seed=0, dropout_rate=0.1)
    losses = []
    for _ in range(2):
        ref_state, loss = step(ref_state, img, caps)
        losses.append(loss)
    assert float(loss_sum) == float(losses[0] + losses[1])
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    assert not torch.equal(next(a.parameters()), next(net.parameters()))   # it trained


def test_train_step_slope(model):
    net, vocab = model
    out = train_step_slope(copy.deepcopy(net), batch=BATCH, seq_len=MAX_LEN,
                           image_size=CFG.image_input_size, vocab=vocab, k=1)
    assert out["batch"] == BATCH and out["step_ms"] > 0
    assert out["images_per_sec"] == pytest.approx(BATCH / (out["step_ms"] / 1000))
