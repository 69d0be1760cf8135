"""Shared pieces of the benchmark's CPU tests: a cell's files cut to a tiny
size (the widths of a CPU test, not of the cell), and ``run_cell`` on the
CPU with the profiler window stubbed (a CPU run reads no device time)."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = dict(image_input_size=256, backbone="mobilenet224_0.35", d_model=32, num_layers=2,
            dff=64, num_heads=2, vocab_size=60, max_seq_len=12, beam_search_n=4)
TINY_TRAFFIC = dict(batch=4, pool=4, check_images=6, span_calls=2, caption_lengths=[4, 12])


def tiny_files(cell: str, **cfg) -> dict:
    from gpubench import run

    files = run.cell_files(cell)
    files["config"].update(TINY, **cfg)
    files["traffic"].update(TINY_TRAFFIC)
    return files


@pytest.fixture
def cpu_run(monkeypatch):
    """``run_cell`` on the CPU at a tiny size; the profiler window returns a
    fixed summary."""
    from gpubench import profiling, run

    torch.set_num_threads(2)
    monkeypatch.setattr(profiling, "profile_calls", lambda fn, name_gaps=True: (fn(), {
        "busy_s": 0.01, "wall_s": 0.02, "device_ops": [["k", 0.01]], "idle_gaps": []})[1])

    def go(cell, seed=7, trace=False, seconds=1.0, **cfg):
        return run.run_cell(tiny_files(cell, **cfg), cell, seed, seconds, trace,
                            torch.device("cpu"), t0=0.0)

    return go
