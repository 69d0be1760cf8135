"""The port's committed convergence evidence on the card, held to the bars of
``tests/test_convergence_artifact.py``: the curves of the d256 proxy and the
flagship that ``fpn_mt_image_captioning_torch/scripts/convergence_run.py``
wrote on an NVIDIA card (the last quarter's mean loss below 0.7 × the first
quarter's, CIDEr improving over its first evaluation, best CIDEr > 0.5), and
their best checkpoints' seven metrics at beam 8 (CIDEr > 8; BLEU-1, BLEU-4,
METEOR and ROUGE-L > 0.8). The curve bars are ``convergence_run.curve_bars``,
which the smoke holds its own run to. A missing file fails; nothing skips. Then one
``--tiny`` run of the script on the CPU (2 epochs, one intra-op thread),
whose curve must be well formed, and which must refuse to write metrics of
a run that saved no checkpoint."""

import json
import pathlib

import pytest

from fpn_mt_image_captioning_torch.scripts import convergence_run
from test_torch_backbones import one_torch_thread  # noqa: F401 (fixture)

ART_DIR = pathlib.Path(convergence_run.OUT_DIR)
CURVES = ["curve_cuda.jsonl", "curve_cuda_flagship.jsonl"]
METRICS = ["full_metrics.json", "full_metrics_flagship.json"]
SEVEN = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L", "CIDEr")


def load_curve(path: pathlib.Path):
    assert path.is_file(), f"{path} is missing: run convergence_run.py on the card"
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    return lines[0], lines[1:]


def named_card(device: str) -> bool:
    """``nvidia-smi``'s ``name, power.limit``: an NVIDIA card and its watts."""
    return device.startswith("NVIDIA ") and device.rstrip().endswith(" W")


@pytest.mark.parametrize("name", CURVES)
def test_card_curve_header(name):
    header, scalars = load_curve(ART_DIR / name)
    assert header["backend"] == "cuda" and named_card(header["device"]), header
    assert header["use_pallas"] is True and header["n_train"] == 200 and header["n_val"] == 18
    want = (512, 512, 6, 2048) if "flagship" in name else (256, 256, 3, 1024)
    assert (header["image_size"], header["d_model"], header["num_layers"], header["dff"]) == want
    assert header["epochs"] == 50 and header["batch_size"] == 16
    assert {s["tag"] for s in scalars} == {"loss", "CIDEr"}


@pytest.mark.parametrize("name", CURVES)
def test_loss_decreases(name):
    _, scalars = load_curve(ART_DIR / name)
    fault = convergence_run.curve_bars(scalars)["loss"]
    assert fault is None, f"{name}: {fault}"


@pytest.mark.parametrize("name", CURVES)
def test_cider_improves(name):
    _, scalars = load_curve(ART_DIR / name)
    fault = convergence_run.curve_bars(scalars)["cider"]
    assert fault is None, f"{name}: {fault}"


@pytest.mark.parametrize("name", METRICS)
def test_full_metric_suite_at_beam8(name):
    """The best checkpoint on the validation split at beam 8: all seven
    metrics, high on this overfit corpus (the all-collapse decode scores
    CIDEr 1.967 and BLEU-1 0.300 here)."""
    path = ART_DIR / name
    assert path.is_file(), f"{path} is missing: run convergence_run.py on the card"
    art = json.loads(path.read_text())
    assert art["beam_search_n"] == 8 and art["backend"] == "cuda", name
    assert named_card(art["device"]) and art["best_epoch"] is not None, art
    m = art["metrics"]
    assert set(SEVEN) <= set(m) and all(m[k] >= 0.0 for k in SEVEN), (name, m)
    assert m["CIDEr"] > 8.0, f"{name}: overfit-corpus CIDEr too low: {m}"
    assert m["Bleu_1"] > 0.8 and m["ROUGE_L"] > 0.8, (name, m)
    assert m["Bleu_4"] > 0.8 and m["METEOR"] > 0.8, (name, m)


def test_tiny_run_writes_a_curve_and_refuses_metrics(tmp_path, one_torch_thread):  # noqa: F811
    """``--tiny`` on the CPU for 2 epochs (one evaluation, which the saver
    takes as its baseline and never saves): a curve of 2 losses and 1 CIDEr
    under its header, then the refusal to evaluate untrained weights."""
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="saved no checkpoint"):
        convergence_run.run("tiny", device="cpu", epochs=2, workspace=str(tmp_path / "ws"),
                            out_dir=out)
    header, scalars = load_curve(out / "curve_cpu.jsonl")
    assert header["setting"] == "tiny" and header["device"] == "cpu" and header["epochs"] == 2
    assert [s["tag"] for s in scalars] == ["loss", "loss", "CIDEr"]
    assert all(set(s) == {"step", "tag", "value", "ts"} for s in scalars)
    assert scalars[1]["value"] < scalars[0]["value"]
    assert not (out / "full_metrics.json").exists()


def test_workspace_must_be_the_scripts_own(tmp_path):
    """A non-empty ``--workspace`` without the script's mark is refused and
    left as it was; in a marked one a rerun removes only what a run writes."""
    foreign = tmp_path / "foreign"
    foreign.mkdir()
    (foreign / "keep.txt").write_text("user data")
    with pytest.raises(ValueError, match="not made by this script"):
        convergence_run.run("tiny", device="cpu", epochs=1, workspace=str(foreign))
    assert [p.name for p in foreign.iterdir()] == ["keep.txt"]

    ws = tmp_path / "ws"
    convergence_run.prepare_workspace(str(ws))
    (ws / "ckpt").mkdir()
    (ws / "ckpt" / "1").write_text("old step")
    (ws / "tokenizer.json").write_text("{}")
    (ws / "notes.txt").write_text("kept")
    convergence_run.prepare_workspace(str(ws))
    assert sorted(p.name for p in ws.iterdir()) == sorted([convergence_run.WORKSPACE_MARK,
                                                            "notes.txt"])
