"""Each cell rehearsed on the CPU at a tiny size, in float32 (the
captioner's plain versions of its kernels): every traffic driver and every
metric reader runs, the result line has the contract's keys, and the
timed path broken underneath turns ``correct`` false. Also the form of
``BENCHMARK.json`` and of every name and unit in it."""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conftest import ROOT
from gpubench import faults

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
CAPTION = [c for c in CELLS if "caption" in c]
TRAIN = [c for c in CELLS if "train" in c]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
F32 = dict(compute_dtype="float32")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "trace"])
def test_cell_runs(cpu_run, cell, trace):
    res = cpu_run(cell, trace=trace, **F32)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert set(res) - {"correct", "attempted", "failed", "metrics", "device"} <= {
        "breakdown", "checks"}
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    key = "per_layer" if trace else "end_to_end"
    listed = {m["name"]: m for m in BENCH[key]
              if cell in m.get("workloads", CELLS)}
    if trace:   # the roofline needs a profiled decode time, which a CPU run has not
        assert set(res["metrics"]) <= set(listed) and res["metrics"]
        assert {"busy_s", "window_s"} <= set(res["device"]) and "breakdown" in res
    else:
        assert set(res["metrics"]) == set(listed)
    for name, m in res["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"]) and m["unit"] == listed[name]["unit"]
        assert isinstance(m["value"], float) and m["value"] > 0
    json.dumps(res)


FAULTS = [(c, f) for c in CAPTION[:1] for f in faults.CAPTION] + [
    (c, f) for c in TRAIN[:1] for f in faults.TRAIN]


@pytest.mark.parametrize("cell, fault", FAULTS, ids=lambda x: getattr(x, "__name__", x))
def test_faults_are_not_correct(cpu_run, monkeypatch, cell, fault):
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

    fault(Pipeline, monkeypatch.setattr)
    res = cpu_run(cell, **F32)
    assert res["correct"] is False, res["checks"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELLS[0], "--seed",
                          "3000000000", "--seconds", "1"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_json_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and BENCH["paths"] == ["gpubench"]
    names = [m["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for m in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert (ROOT / "gpubench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "gpubench" / "workloads" / f"{w['name']}.json").is_file()
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert (ROOT / "gpubench" / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]} and UNIT.match(m["unit"])
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
