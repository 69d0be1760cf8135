"""Training-convergence evidence on the card (the port of the repository's
``scripts/convergence_run.py``): overfit a class-correlated synthetic corpus
through the port's ``train`` main and record the loss/CIDEr curve and the
full metric table of the best checkpoint at beam 8.

    python -m fpn_mt_image_captioning_torch.scripts.convergence_run            # d256 proxy
    python -m fpn_mt_image_captioning_torch.scripts.convergence_run --flagship # 512², d 512, 6+6
    python -m fpn_mt_image_captioning_torch.scripts.convergence_run --tiny --device=cpu

The corpus and the three settings are the JAX script's: 200 training and 18
validation images whose caption is a function of the image (a bright band
whose position selects one of six captions,
``tests/fixtures.make_synthetic_dataset(classful=True)``); ``--tiny`` (24 + 6
images, d 32, 2+2 layers, 4 epochs), the d256 proxy (256², d 256, 3+3
layers, dff 1024, 8 heads) and ``--flagship`` (512², d 512, 6+6 layers, dff
2048, 8 heads, a decoded-image cache), each at batch 16 (8 for ``--tiny``),
50 epochs, an evaluation every 5, warmup 1000, dropout 0 and the BatchNorm
moments re-estimated over an epoch's batches before each evaluation.

One thing differs from the JAX script, on purpose: every evaluation runs the
port's main path, the fused beam search on the decode kernels
(``use_pallas=True``), where the JAX run used XLA's decode. So ``--tiny``
runs at 128² where the JAX script's runs at 64²: a 64² image leaves the
encoder no position (Lenc 0), which the fused step refuses in both
packages.

The curve is written first. After training the saver's best step is restored (not the latest, which the
saver's early-epoch resets can make a worse one) and evaluated on the
validation split at beam 8 through ``Pipeline.evaluate`` and ``MetricEval``
(BLEU-1..4, METEOR, ROUGE-L, CIDEr). A run that never saved a checkpoint
raises rather than write an evaluation of untrained weights.

Writes ``curve_cuda[_flagship].jsonl`` (a header line, then one scalar a
line) and ``full_metrics[_flagship].json`` into ``--out_dir`` (default: the
``convergence/`` directory beside this file; ``--tiny`` writes into its
workspace unless ``--out_dir`` is given). The header carries the card's name
and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them, or ``cpu``. ``--epochs=N`` shortens a
run; ``--workspace=DIR`` keeps the corpus, logs and checkpoints (default: a
temporary directory, removed at the end). A workspace must be empty or one
this script made (it holds the ``WORKSPACE_MARK`` file); a rerun there
removes only the entries the script writes. The last line printed is a JSON
summary: the loss and CIDEr ends, the ``train`` main's wall, the median
train step's seconds (the first, which warms up, left out) and images/s,
each evaluation's seconds, and the beam-8 evaluation's. ``curve_bars`` holds
a curve to the convergence test's bars; the smoke and the tests share it.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
OUT_DIR = HERE / "convergence"
WORKSPACE_MARK = ".convergence_run"
# what a run writes into its workspace, and so what a rerun there removes
WORKSPACE_ENTRIES = ("data", "ckpt", "logs", "results", "imgcache", "artifact",
                     "tokenizer.json", "additional.json", "weights.msgpack")

# (n_train, n_val, image_size, model widths, epochs, eval every, batch, warmup)
SETTINGS = {
    "tiny": (24, 6, 128, dict(d_model=32, num_layers=2, dff=64, num_heads=4), 4, 2, 8, 20),
    "d256": (200, 18, 256, dict(d_model=256, num_layers=3, dff=1024, num_heads=8),
             50, 5, 16, 1000),
    "flagship": (200, 18, 512, dict(d_model=512, num_layers=6, dff=2048, num_heads=8),
                 50, 5, 16, 1000),
}


def card_name(device) -> str:
    """The card's name and power limit from ``nvidia-smi``, or the device's
    type where it is not a CUDA card."""
    if device.type != "cuda":
        return device.type
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def config_for(setting: str, ws: str, epochs: int | None = None):
    """The run's ``Config`` over the workspace ``ws``, and the setting's
    numbers (n_train, n_val, image_size, widths, epochs, batch)."""
    from ..config import Config

    n_train, n_val, size, widths, n_epochs, every, batch, warmup = SETTINGS[setting]
    n_epochs = n_epochs if epochs is None else epochs
    cfg = Config(
        datadir=os.path.join(ws, "data"),
        tokenizer_filename=os.path.join(ws, "tokenizer.json"),
        additional_filename=os.path.join(ws, "additional.json"),
        transformer_checkpoint_path=os.path.join(ws, "ckpt"),
        transformer_weight_path=os.path.join(ws, "weights.msgpack"),
        result_dir=os.path.join(ws, "results"),
        image_input_size=size, batch_size=batch, epochs=n_epochs,
        n_epoch_to_evaluate=every, n_val_dataset=None, warm_up_steps=warmup,
        beam_search_n=4, buffer_size=max(n_train, 1), dropout_rate=0.0,
        use_pallas=True,
        # from-scratch BatchNorm statistics at the Keras momentum are useless
        # after ~650 steps: exact population moments before every evaluation
        bn_finalize_batches=n_train // batch,
        dataset_cache=os.path.join(ws, "imgcache") if setting == "flagship" else "",
        **widths)
    return cfg, dict(n_train=n_train, n_val=n_val, image_size=size, batch_size=batch,
                     epochs=n_epochs, **widths)


@contextlib.contextmanager
def timed_calls(calls: dict):
    """Record the seconds of each ``Pipeline`` method call named in
    ``calls`` (a ``train_step`` returns a float loss, so it waits for the
    card), and put the methods back afterwards."""
    from ..train.pipeline import Pipeline

    saved = {name: getattr(Pipeline, name) for name in calls}

    def timing(name, fn):
        def call(self, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(self, *args, **kwargs)
            finally:
                calls[name].append(time.perf_counter() - t0)
        return call

    for name, fn in saved.items():
        setattr(Pipeline, name, timing(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(Pipeline, name, fn)


def curve_bars(scalars: list) -> dict:
    """``tests/test_convergence_artifact.py``'s bars on a curve's scalars:
    the last quarter's mean loss below 0.7 × the first quarter's (at least
    4 epochs), CIDEr improving over its first evaluation (or above 1 there)
    and its best above 0.5 (at least 2 evaluations). Returns the quarter
    means, the losses and CIDErs, and under ``"loss"`` and ``"cider"`` what
    failed, or None."""
    losses = [s["value"] for s in scalars if s["tag"] == "loss"]
    ciders = [s["value"] for s in scalars if s["tag"] == "CIDEr"]
    q = max(len(losses) // 4, 1)
    first_q, last_q = sum(losses[:q]) / q, sum(losses[-q:]) / q
    loss = cider = None
    if len(losses) < 4:
        loss = f"too few epochs ({len(losses)})"
    elif not last_q < 0.7 * first_q:
        loss = (f"loss did not drop (first-quartile mean {first_q:.3f} -> "
                f"last-quartile mean {last_q:.3f})")
    if len(ciders) < 2:
        cider = f"need at least 2 evaluations ({ciders})"
    elif not (max(ciders[1:]) > ciders[0] or ciders[0] > 1.0):
        cider = f"CIDEr never improved over its first evaluation ({ciders})"
    elif not max(ciders) > 0.5:
        cider = f"best CIDEr {max(ciders):.3f} too low"
    return {"first_quarter_loss": first_q, "last_quarter_loss": last_q, "losses": losses,
            "ciders": ciders, "loss": loss, "cider": cider}


def beam8_metrics(cfg, device) -> tuple[dict, int]:
    """The saver's best step restored and evaluated on the validation split
    at beam 8: the seven metrics and the step. Raises when no checkpoint was
    saved, or when the best step is not among the saved ones."""
    import dataclasses

    from ..data.dataset import COCO_Images_ImageID, load_additional_info
    from ..train.pipeline import Pipeline

    eval_cfg = dataclasses.replace(cfg, is_training=False, beam_search_n=8)
    additional = load_additional_info(cfg.additional_filename)
    step = additional.get("mt_epoch_" + os.path.basename(cfg.transformer_checkpoint_path))
    master = Pipeline(cfg.tokenizer_filename, additional["max_seq_len"], eval_cfg,
                      device=device, checkpoint_path=cfg.transformer_checkpoint_path)
    steps = master.ckpt_manager.all_steps()
    if not steps:
        raise RuntimeError("the convergence run saved no checkpoint (CIDEr never improved): "
                           "refusing to write an evaluation of untrained weights")
    if step not in steps:
        raise RuntimeError(f"the saver's best step {step!r} is not among the saved steps "
                           f"{steps}: refusing to evaluate another step under its name")
    master.load_state_tree(master.ckpt_manager.restore(master.state_tree(), step=step))
    val = COCO_Images_ImageID(cfg.datadir, cfg.datatype_val, cfg.n_val_dataset,
                              image_size=cfg.image_input_size)
    results = master.evaluate(iter(val))
    res_file = os.path.join(cfg.result_dir, "beam8_captions_result.json")
    os.makedirs(os.path.dirname(res_file), exist_ok=True)
    with open(res_file, "w") as f:
        json.dump(results, f)
    master.metric_eval(res_file)
    return dict(master.metric_eval.eval), step


def prepare_workspace(ws: str) -> None:
    """Make ``ws`` a workspace: create it, or empty one that a run made of
    the entries a run writes. A non-empty directory without the mark is
    refused, so a mistyped path deletes nothing."""
    if os.path.isdir(ws) and os.listdir(ws):
        if not os.path.isfile(os.path.join(ws, WORKSPACE_MARK)):
            raise ValueError(f"--workspace={ws} is not empty and was not made by this "
                             f"script (no {WORKSPACE_MARK} file): refusing to clear it")
        for name in WORKSPACE_ENTRIES:
            path = os.path.join(ws, name)
            if os.path.isdir(path):
                shutil.rmtree(path)
            elif os.path.exists(path):
                os.remove(path)
    os.makedirs(ws, exist_ok=True)
    Path(ws, WORKSPACE_MARK).touch()


def run(setting: str = "d256", *, device=None, epochs: int | None = None,
        workspace: str | None = None, out_dir: str | Path | None = None) -> dict:
    """Generate the corpus, train through the ``train`` main, evaluate the
    best checkpoint at beam 8 and write the two files; returns the summary
    (also the paths written and the walls)."""
    sys.path.insert(0, str(REPO / "tests"))
    from fixtures import make_synthetic_dataset

    from ..train.__main__ import main as train_main
    from ..train.pipeline import resolve_device

    device = resolve_device(device)
    own_ws = workspace is None
    ws = tempfile.mkdtemp(prefix="convergence_") if own_ws else os.path.abspath(workspace)
    try:
        if not own_ws:
            prepare_workspace(ws)
        cfg, shape = config_for(setting, ws, epochs)
        make_synthetic_dataset(cfg.datadir, n_train=shape["n_train"], n_val=shape["n_val"],
                               image_size=shape["image_size"], classful=True)
        calls = {"train_step": [], "evaluate": []}
        t0 = time.perf_counter()
        with contextlib.chdir(ws), timed_calls(calls):   # the main writes logs/ here
            train_main(cfg, device=device)
        train_s = time.perf_counter() - t0
        log_root = os.path.join(ws, "logs", "transformer")
        run_dir = sorted(os.listdir(log_root))[-1]
        with open(os.path.join(log_root, run_dir, "train", "scalars.jsonl")) as f:
            scalars = [json.loads(line) for line in f]

        out = Path(out_dir) if out_dir is not None else (
            Path(ws) / "artifact" if setting == "tiny" else OUT_DIR)
        out.mkdir(parents=True, exist_ok=True)
        suffix = "_flagship" if setting == "flagship" else ""
        card = card_name(device)
        curve = out / f"curve_{device.type}{suffix}.jsonl"
        header = {"run": "convergence" + suffix, "backend": device.type, "device": card,
                  "setting": setting, "use_pallas": True, **shape}
        with open(curve, "w") as f:
            f.write(json.dumps(header) + "\n")
            for s in scalars:
                f.write(json.dumps(s) + "\n")
        losses = [s["value"] for s in scalars if s["tag"] == "loss"]
        ciders = [s["value"] for s in scalars if s["tag"] == "CIDEr"]
        steps = calls["train_step"][1:] or calls["train_step"]   # the first warms up
        summary = {"setting": setting, "device": card, "epochs": len(losses),
                   "first_loss": losses[0], "last_loss": losses[-1],
                   "first_cider": ciders[0] if ciders else None,
                   "best_cider": max(ciders) if ciders else None,
                   "train_main_s": train_s, "train_steps": len(calls["train_step"]),
                   "step_s_median": statistics.median(steps),
                   "images_per_s": shape["batch_size"] / statistics.median(steps),
                   "evaluate_s": calls["evaluate"], "curve": str(curve)}

        t0 = time.perf_counter()
        metrics, best_epoch = beam8_metrics(cfg, device)
        full = out / f"full_metrics{suffix}.json"
        with open(full, "w") as f:
            json.dump({"protocol": "best checkpoint, val split, beam_search_n=8 — the "
                                   "reference README's run config (BASELINE.md rows)",
                       "backend": device.type, "device": card, "n_val": shape["n_val"],
                       "beam_search_n": 8, "best_epoch": best_epoch,
                       "metrics": {k: round(float(v), 4) for k, v in metrics.items()}},
                      f, indent=2)
        summary.update(best_epoch=best_epoch, full_metrics_beam8=metrics,
                       beam8_eval_s=time.perf_counter() - t0, full_metrics=str(full))
        return summary
    finally:
        if own_ws:
            shutil.rmtree(ws, ignore_errors=True)


def main(argv) -> int:
    setting, kw = "d256", {}
    for a in argv:
        if a in ("--tiny", "--flagship"):
            setting = a[2:]
        elif a.startswith("--epochs="):
            kw["epochs"] = int(a.split("=", 1)[1])
        elif a.startswith("--device="):
            kw["device"] = a.split("=", 1)[1]
        elif a.startswith("--workspace="):
            kw["workspace"] = a.split("=", 1)[1]
        elif a.startswith("--out_dir="):
            kw["out_dir"] = a.split("=", 1)[1]
        else:
            raise SystemExit(f"unknown argument {a!r}")
    print(json.dumps(run(setting, **kw), default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
