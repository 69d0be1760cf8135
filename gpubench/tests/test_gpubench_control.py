"""The control that each cell's limits were tested against: the reference
put in the captioner's place and computed in float8, the precision below
the configuration's bfloat16, has to come out as not correct, and so has
each fault that ``gpubench/control.py`` reads. At a tiny size on
the CPU here; at the cell's own size, on three seeds, on the card (marked
``cuda``; it skips without one):

    python -m pytest -p no:cacheprovider -q -m cuda gpubench/tests/test_gpubench_control.py
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from conftest import tiny_files
from gpubench import control, run

HERE = Path(__file__).resolve().parent

BENCH = json.loads((HERE.parents[1] / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def failed(reading: dict, limits: dict) -> list[str]:
    return [k for k, lim in limits.items() if k in reading and not reading[k] <= lim]


def assert_fails(readings: dict, limits: dict) -> None:
    """Every reading but the captioner's own fails a limit."""
    assert "program" in readings and len(readings) > 1
    for name, reading in readings.items():
        if name != "program":
            assert failed(reading, limits), (name, reading, limits)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_a_tiny_size(cell):
    torch.set_num_threads(2)
    files = tiny_files(cell)
    assert_fails(control.readings(files, 3, torch.device("cpu")), files["limits"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    files = run.cell_files(cell)
    for seed in (3900000001, 3900000002, 3900000003):
        assert_fails(control.readings(files, seed, torch.device("cuda")), files["limits"])
