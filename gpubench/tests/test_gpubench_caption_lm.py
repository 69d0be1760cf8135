"""The cell whose decoder is a language model (``kimivl.caption_b256``)
rehearsed on the CPU, in float32, at a tiny text config beside the
rehearsal's tiny encoder (``conftest.TINY``): its driver and readers run,
the run is correct, and each planted fault of ``faults_lm.py`` turns
``correct`` false. (``test_gpubench_rehearsal.py`` runs every cell at the
encoder's tiny size alone, which leaves this cell's language model at its
published widths: the driver refuses to build those on a CPU.)"""

from __future__ import annotations

import json

import pytest

from conftest import ROOT
from gpubench import faults_lm

CELL = "kimivl.caption_b256"
TEXT = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=4, n_shared_experts=1, n_routed_experts=8,
            kv_lora_rank=32, qk_rope_head_dim=8, v_head_dim=16, qk_nope_head_dim=16,
            num_experts_per_tok=2, compute_dtype="float32")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# at this size the cell's damped residual branches (branch 0.3, embedding 4)
# leave a fault's score gap under the limit; the faults are planted here on
# undamped ones (at the cell's widths they read 6-14x the limit, PERF.md §2)
FAULT_SCALES = {"embedding": 1.0, "lm_head": 5.0, "branch": 1.0, "correction_bias": 0.1}


@pytest.mark.parametrize("trace", [False, True], ids=["e2e", "trace"])
def test_the_cell_runs_at_a_tiny_text_config(cpu_run, trace):
    res = cpu_run(CELL, trace=trace, **TEXT)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    key = "per_layer" if trace else "end_to_end"
    listed = {m["name"] for m in BENCH[key] if CELL in m.get("workloads", [CELL])}
    if trace:   # the roofline needs a profiled decode time, which a CPU run has not
        assert {"lm_prefill_ms.caption_lm", "moe_rows_per_expert.caption_lm",
                "caption_mfu.caption_lm"} <= set(res["metrics"]) <= listed
        assert res["metrics"]["moe_rows_per_expert.caption_lm"]["value"] == pytest.approx(
            4 * 4 * 2 / 8)   # batch 4 × beam 4 rows × 2 choices over 8 experts
    else:
        assert set(res["metrics"]) == listed == {"caption_images_per_s", "setup_s"}


@pytest.mark.parametrize("fault", faults_lm.CAPTION_LM, ids=lambda f: f.__name__)
def test_faults_are_not_correct(cpu_run, monkeypatch, fault):
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

    assert cpu_run(CELL, lm_weight_scales=FAULT_SCALES, **TEXT)["correct"] is True
    fault(Pipeline, monkeypatch.setattr)
    res = cpu_run(CELL, lm_weight_scales=FAULT_SCALES, **TEXT)
    assert res["correct"] is False, res["checks"]


def test_published_widths_are_refused_on_a_cpu(cpu_run):
    with pytest.raises(RuntimeError, match="CUDA card only"):
        cpu_run(CELL, compute_dtype="float32")


def test_counts_are_the_products_the_port_runs():
    """``counts_lm`` against PyTorch's FLOP counter over the port's prefill
    and decode step at a tiny size: equal, but for the routed experts, which
    the counter does not see inside ``torch._grouped_mm``, and for the
    prefill's scores, which the port computes over the whole square and the
    count over its causal half."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from conftest import TINY
    from fpn_mt_image_captioning_torch.config import Config
    from fpn_mt_image_captioning_torch.models.kimi_vl import TEXT_CONFIG_KEYS
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
    from gpubench import counts_lm, harness, inputs_lm, run

    torch.set_num_threads(2)
    cfg = {**run.cell_files(CELL)["config"], **TINY, **TEXT}
    b, beam, pos = 2, cfg["beam_search_n"], 3
    state = inputs_lm.weights(cfg, 5, "cpu", dtype=torch.float32)
    pipe = Pipeline(harness.tokenizer(cfg["vocab_size"]), cfg["max_seq_len"],
                    harness.program_config(cfg, language_model={k: cfg[k] for k in TEXT_CONFIG_KEYS}),
                    state, device="cpu")
    model = pipe.transformer
    enc = pipe.encode(torch.zeros((b, 256, 256, 3), dtype=torch.uint8).numpy())
    with FlopCounterMode(display=False) as prefill:
        cache = model.init_beam_cache(enc, beam, pos + 1)
    src = torch.arange(b * beam)[:, None].repeat(1, pos + 1)
    with FlopCounterMode(display=False) as step:
        model.decode_step(torch.full((b * beam,), 5), pos, cache, src)
    d, w, k = cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["num_experts_per_tok"]
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    experts = 2 * 3 * d * k * w * moe_layers            # a row's routed products
    n = enc.shape[1] + 1
    head = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"]
    square = 2 * b * cfg["num_attention_heads"] * head * (n * n - n * (n + 1) // 2)
    assert (prefill.get_total_flops() + b * n * experts - square * cfg["num_hidden_layers"]
            == counts_lm.prefill_flops(cfg, b, enc.shape[1]))
    assert (step.get_total_flops() + b * beam * experts
            == counts_lm.decode_step(cfg, b, beam, n, pos, 0.0)[0])


def test_control_and_faults_fail_at_a_tiny_size():
    """``control_lm.readings``: the float8 control and each fault fail a
    limit of the cell (the faults on undamped branches, as above)."""
    import torch

    from conftest import tiny_files
    from gpubench import control_lm

    torch.set_num_threads(2)
    files = tiny_files(CELL, lm_weight_scales=FAULT_SCALES, **TEXT)
    readings = control_lm.readings(files, 3, torch.device("cpu"), seconds=1.0)
    assert set(readings) == {"program", "control", *(f.__name__ for f in faults_lm.CAPTION_LM)}
    limits = files["limits"]
    for name, reading in readings.items():
        failed = [k for k, lim in limits.items() if not reading[k] <= lim]
        assert bool(failed) == (name != "program"), (name, reading, limits)
