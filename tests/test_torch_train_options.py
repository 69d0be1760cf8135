"""The ``train`` main's ``profile_dir`` and ``export_artifact_dir`` on the CPU
(the JAX package's root ``train.py:98-106`` and ``:226-245``): the step
tracer writes a ``torch.profiler`` trace of the train steps, the main exports
the trained weights' serving artifact, which captions as the trained
pipeline does, and a failed export is printed, not raised. The synthetic
split and the small model of ``tests/test_torch_train_loop.py`` (256²,
mobilenet224_0.35, d 32, 2+2 layers, batch 3); torch on one intra-op
thread."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from fixtures import make_synthetic_dataset
from fpn_mt_image_captioning_torch.export import load_serving
from fpn_mt_image_captioning_torch.train.__main__ import main as train_main
from test_torch_train_loop import SIZE, both_configs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (see
    tests/test_torch_backbones.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def datadir(tmp_path_factory):
    """4 training images (a batch of 3 and a tail of 1), 2 validation ones."""
    root = tmp_path_factory.mktemp("train_options")
    return make_synthetic_dataset(str(root / "data"), n_train=4, n_val=2, image_size=SIZE)


def run_main(root, datadir, **options):
    """The ``train`` main over one epoch (two steps) with ``options``, no
    evaluation (the final weights are saved, and exported where asked), in
    ``root``; returns the pipeline and what the main printed."""
    _, cfg = both_configs(root, datadir, **options)
    cwd, out = os.getcwd(), io.StringIO()
    os.chdir(root)
    try:
        with contextlib.redirect_stdout(out):
            pipe = train_main(cfg.replace(epochs=1, n_epoch_to_evaluate=10), device="cpu")
    finally:
        os.chdir(cwd)
    return pipe, out.getvalue()


@pytest.fixture(scope="module")
def optioned_run(datadir, tmp_path_factory, one_torch_thread):
    root = tmp_path_factory.mktemp("optioned")
    pipe, out = run_main(root, datadir, profile_dir=str(root / "profile"),
                         export_artifact_dir=str(root / "artifact"))
    return dict(root=root, pipe=pipe, out=out)


def test_train_main_profile_dir_writes_the_step_trace(optioned_run):
    """``--profile_dir``: a ``torch.profiler`` trace of the step window
    (the window opens at step 1; the run has two steps, so the tracer's
    ``close`` after the epoch loop writes it), holding the train step's ops."""
    assert len(optioned_run["pipe"].train_loss_history) == 2
    [path] = list((optioned_run["root"] / "profile").glob("*.pt.trace.json"))
    events = json.loads(path.read_text())["traceEvents"]
    ops = {e["name"] for e in events if e.get("cat") == "cpu_op"}
    assert {"aten::convolution", "aten::linear"} <= ops


def test_train_main_exports_the_trained_weights(optioned_run):
    """``--export_artifact_dir``: after training the main exports the saved
    weights; the artifact loads and captions as the trained pipeline does."""
    root, pipe = optioned_run["root"], optioned_run["pipe"]
    assert "Exported serving artifact (batch=2, beam=2)" in optioned_run["out"]
    served = load_serving(str(root / "artifact"), "cpu")
    assert served.meta["sampling"] is False and served.meta["compute_dtype"] == "float32"
    imgs = np.random.default_rng(3).integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8)
    got, want = served.predict_batch(imgs), pipe.predict_batch(imgs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_train_main_prints_a_failed_export(datadir, tmp_path, monkeypatch):
    """A failed export is printed, not raised: the weights are saved by
    then, and the run ends normally."""
    import fpn_mt_image_captioning_torch.train.__main__ as main_module

    def refuse(*a, **k):
        raise RuntimeError("no room")

    monkeypatch.setattr(main_module, "export_serving", refuse)
    pipe, out = run_main(tmp_path, datadir, export_artifact_dir=str(tmp_path / "a"))
    assert "export_artifact_dir: export failed (RuntimeError: no room)" in out
    assert os.path.isfile(tmp_path / "weights.msgpack") and len(pipe.train_loss_history) == 2
