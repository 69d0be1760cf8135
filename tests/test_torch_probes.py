"""The port's measurement probes (``fpn_mt_image_captioning_torch/scripts/``,
``ops/probes.py``) against the TPU probes in the repository's ``scripts/``,
on the CPU. The TPU scripts are loaded from their files, their
``pl.pallas_call`` runs in Pallas interpret mode and their size constants are
cut to a few kilobytes (``monkeypatch``), so nothing in ``scripts/`` changes.
Every comparison is exact: x + 1 and 2·x are exact in their dtypes, and the
step's result is a copy of one of its inputs (the TPU's of x, the port's of
the running scores).

The kernels themselves run only on the card (``test_torch_cuda_kernels.py``);
here the wrappers take their plain versions, as they do for any CPU tensor.
"""

import functools
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from fpn_mt_image_captioning_torch.ops import probes as pr
from fpn_mt_image_captioning_torch.scripts import probe_grid_cell as pgc
from fpn_mt_image_captioning_torch.scripts import probe_launch_overhead as plo
from fpn_mt_image_captioning_torch.scripts import probe_pallas_overhead as ppo

REPO = pathlib.Path(__file__).resolve().parents[1]
# the decoder-shaped launch cut down: BK = B_ITEMS · BEAM rows of width D
TPU_STEP = dict(BK=16, D=128, DFF=256, VP=256, LPAD=8, LENC=4, BITEMS=2, NL=2, TILE=16)
PORT_STEP = dict(D=128, DFF=256, V=256, LPAD=8, LENC=4, B_ITEMS=2, NL=2, H=4, BEAM=8, TILE=16)
GRID = dict(B=2, HP=10, WP=16, ROWS=4, N_TILES=2)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"tpu_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _freevars(fn) -> dict:
    """A closure's free variables by name (the TPU probes keep their
    ``pallas_call`` wrappers and operands in closures)."""
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))


@pytest.fixture
def tpu(monkeypatch):
    """The three TPU probe modules, interpret mode, small constants; the
    port's scripts get the same constants."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    mods = {n: _load(n) for n in ("probe_launch_overhead", "probe_pallas_overhead",
                                  "probe_grid_cell")}
    for k, v in TPU_STEP.items():
        monkeypatch.setattr(mods["probe_launch_overhead"], k, v)
    for k, v in PORT_STEP.items():
        monkeypatch.setattr(plo, k, v)
    for k, v in GRID.items():
        monkeypatch.setattr(mods["probe_grid_cell"], k, v)
        monkeypatch.setattr(pgc, k, v)
    return mods


@pytest.mark.parametrize("variant", ["a", "b"])
@pytest.mark.parametrize("n", [1, 3])
def test_launch_overhead_chains_match_tpu(tpu, variant, n):
    """Variants A and B: the sum after n links on (256, 256) zeros."""
    want = float(getattr(tpu["probe_launch_overhead"], f"variant_{variant}")()(n)())
    got = float(getattr(plo, f"variant_{variant}")(torch.device("cpu"))(n)())
    assert got == want == 65536.0 * n


@pytest.mark.parametrize("variant", ["a", "b"])
def test_add_one_kernels_match_tpu_on_seeded_input(tpu, variant):
    """The TPU kernel itself (its ``pallas_call`` wrapper, from the
    closure) and the port's wrapper on the same seeded array."""
    x = np.random.default_rng(3).standard_normal((256, 256)).astype(np.float32)
    call = _freevars(getattr(tpu["probe_launch_overhead"], f"variant_{variant}")())["call"]
    want = np.asarray(call(jnp.asarray(x)))
    wrapper = pr.add_one if variant == "a" else pr.add_one_grid7
    np.testing.assert_array_equal(wrapper(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("n", [1, 8])
def test_chain_matches_chain_pallas(tpu, n):
    x = np.zeros((256, 256), np.float32)
    want = float(tpu["probe_pallas_overhead"].chain_pallas(jnp.asarray(x), n))
    got = float(ppo.chain(torch.from_numpy(x), n))
    assert got == want == float(ppo.chain_plain(torch.from_numpy(x), n)) == 65536.0 * n


# TPU variant_c keywords; the port's variant with the same meaning
STEP_VARIANTS = {"C": dict(), "D": dict(compute_dots=2), "E": dict(with_oh=False)}


@pytest.mark.parametrize("variant", sorted(STEP_VARIANTS))
def test_decoder_shaped_step_matches_tpu(tpu, variant):
    """Both probes' steps return a copy of one input: the TPU's
    decoder-shaped launch (its ``call`` from the closure, its own zero
    operands) tops = x[:, :128] on a seeded x, the port's step the running
    scores in every column on seeded scores. Both runners, on the zero
    inputs they run on, give the same result."""
    kw = STEP_VARIANTS[variant]
    make = tpu["probe_launch_overhead"].variant_c(**kw)
    want_run = float(make(2)())
    cells = _freevars(make(1))
    x = np.random.default_rng(4).standard_normal((16, 128)).astype(np.float32)
    x_bf = jnp.asarray(x, jnp.bfloat16)
    tops, _, _ = _freevars(make)["call"](cells["args"], x_bf, cells["k_hbm"], cells["v_hbm"])
    np.testing.assert_array_equal(np.asarray(tops)[:, :128], np.asarray(x_bf, np.float32))

    device = torch.device("cpu")
    got_run = plo.variant_c(device, **kw)(2)()
    assert float(got_run.sum()) == want_run == 0.0
    s = plo.step_setup(device, kw.get("with_oh", True), kw.get("compute_dots", 0))
    s["scores"] = torch.from_numpy(x[:, :1].copy())
    got = pr.probe_step(s)
    assert got.shape == (16, PORT_STEP["BEAM"]) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.repeat(x[:, :1], PORT_STEP["BEAM"], 1))


@pytest.mark.parametrize("with_oh,dots", [(True, 0), (False, 1)])
def test_probe_step_contract_and_shapes(with_oh, dots):
    """On the CPU the probe's step returns its plain version and launches
    nothing; the kinds it launches on the card (the trivial build's wrappers,
    the one-hot check, the real linears) compose into the decode step:
    through the same ``decode_step_with`` on the CPU, where every wrapper
    takes its plain version, they give ``fused_decode_step_reference``'s
    result, and ``fused_decode_step``'s own arguments and output shapes."""
    pr.reset_launch_counts()
    fd = pr.fd
    s = pr.step_setup(b_items=3, beam=4, d=32, num_heads=4, dff=64, vocab=50, num_layers=3,
                      lpad=8, lenc=3, with_oh=with_oh, tile=8, compute_dots=dots, device="cpu")
    s["scores"] = torch.from_numpy(
        np.random.default_rng(9).standard_normal((12, 1)).astype(np.float32))
    tops = pr.probe_step(s)
    assert torch.equal(tops, s["scores"].repeat(1, 4)) and tops.dtype == torch.float32
    assert all(k.launches == 0 for k in pr.KERNELS)
    assert (s["ops"] is pr.TRIVIAL_DECODER.KERNEL_OPS) == (not with_oh and not dots)

    x = torch.from_numpy(np.random.default_rng(10).standard_normal((12, 32)).astype(np.float32))
    args = (s["packed"], s["cache"], x.bfloat16(), s["src_t"], 0, s["scores"], s["finished"])
    kw = dict(num_layers=3, beam=4, num_heads=4, topk=None, activation="leaky_relu")
    got_s, got_i = pr.TRIVIAL_DECODER.decode_step_with(s["ops"], *args, **kw)
    want_s, want_i, _ = fd.fused_decode_step_reference(*args, **kw)
    assert torch.equal(got_s, want_s) and torch.equal(got_i, want_i)
    assert got_s.shape == got_i.shape == (12, 4) and got_i.dtype == torch.int32
    assert all(k.launches == 0 for k in pr.KERNELS + fd.KERNELS)


@pytest.mark.parametrize("layout,wrapper", [("A", pr.slab_copy_4d), ("B", pr.slab_copy_3d),
                                            ("C", pr.slab_copy_lane128), ("D", pr.slab_copy_flat),
                                            ("D", pr.slab_copy_flat_loads),
                                            ("D", pr.slab_copy_flat_cp_async)])
def test_grid_cell_variants_match_tpu(tpu, layout, wrapper):
    """Every written row of the TPU variant's output (rows 1 … ROWS·N_TILES
    of each item) equals the port's on the same seeded bf16 input, in the
    TPU variant's output shape."""
    b, hp, wp, rows, n_tiles = (GRID[k] for k in ("B", "HP", "WP", "ROWS", "N_TILES"))
    x = np.random.default_rng(ord(layout)).standard_normal((b, hp, wp, 32)).astype(np.float32)
    want = tpu["probe_grid_cell"].__dict__[f"variant_{layout.lower()}"]()(
        jnp.asarray(x, jnp.bfloat16))
    got = wrapper(torch.from_numpy(x).bfloat16(), rows, n_tiles)
    assert tuple(got.shape) == want.shape
    want_rows = np.asarray(want, np.float32).reshape(b, hp, wp, -1)[:, 1:1 + rows * n_tiles]
    np.testing.assert_array_equal(pr.slab_rows(got, x.shape, rows, n_tiles).float().numpy(),
                                  want_rows)
    np.testing.assert_array_equal(want_rows[..., :32], 2 * np.asarray(
        jnp.asarray(x, jnp.bfloat16), np.float32)[:, 1:1 + rows * n_tiles])


@pytest.mark.parametrize("layout,hp,wp,c,rows,want", [
    ("A", 258, 272, 32, 64, dict(chunk=4, nbox=2, box_w=136, nchunks=16, box_bytes=34816)),
    ("B", 258, 272, 32, 64, dict(chunk=4, nbox=2, box_w=136, nchunks=16, box_bytes=34816)),
    ("C", 258, 272, 128, 64, dict(chunk=1, nbox=2, box_w=136, nchunks=64, box_bytes=34816)),
    ("D", 258, 272, 32, 64, dict(chunk=256, nbox=4, nchunks=17, box_bytes=16384)),
    ("A", 23, 300, 32, 7, dict(chunk=3, nbox=2, box_w=150, nchunks=3)),
    ("C", 23, 300, 128, 7, dict(chunk=1, nbox=2, box_w=150, nchunks=7)),
    ("D", 10, 16, 8, 4, dict(chunk=64, nbox=1, nchunks=1)),
])
def test_slab_plan(layout, hp, wp, c, rows, want):
    """The flagship plans, and the walk's invariants on ragged shapes: boxes
    within TMA's 256 elements, a row covered by the boxes, every row (or
    pixel) of the slab covered by the chunks, two stages within 227 KB."""
    plan = pr.slab_plan(layout, hp, wp, c, rows)
    assert {k: plan[k] for k in want} == want
    assert plan["chunk"] <= 256 and plan["box_w"] <= 256
    assert plan["smem"] <= pr.MAX_SMEM and plan["slot_bytes"] % 128 == 0
    if layout == "D":
        assert plan["nchunks"] * plan["nbox"] * plan["chunk"] >= rows * wp
        assert plan["nbox"] * plan["chunk"] <= rows * wp
    else:
        assert plan["nbox"] * plan["box_w"] >= wp and plan["box_w"] <= wp
        assert plan["nchunks"] * plan["chunk"] >= rows >= plan["chunk"]


def test_slab_copy_refusals():
    with pytest.raises(ValueError, match="16 bytes"):
        pr.flat_chunk_bytes(4, 3, 4)
    assert pr.flat_chunk_bytes(64, 272, 32) == pr.STAGE_BYTES
    with pytest.raises(ValueError, match="do not fit"):
        pr.slab_copy_reference(torch.zeros(1, 8, 4, 8, dtype=torch.bfloat16), "A", 4, 2)
    with pytest.raises(ValueError, match="bf16"):
        pr.slab_copy_4d(torch.zeros(1, 10, 4, 8), 4, 2)
    with pytest.raises(ValueError, match="layout"):
        pr.slab_plan("E", 10, 16, 32, 4)
    with pytest.raises(ValueError, match="shared memory"):
        pr.slab_plan("A", 10, 4096, 128, 4)


@pytest.mark.parametrize("call", [
    lambda m: pr.add_one(torch.zeros(4, device=m)),
    lambda m: pr.add_one_grid7(torch.zeros(4, device=m)),
    lambda m: pr.TRIVIAL_DECODER.decoder_linear(
        torch.zeros(2, 3, device=m), torch.zeros(3, 4, device=m), torch.zeros(4, device=m)),
    lambda m: pr.slab_copy_flat_cp_async(
        torch.zeros(1, 10, 16, 8, dtype=torch.bfloat16, device=m), 4, 2),
])
def test_wrappers_refuse_other_devices(call):
    with pytest.raises(ValueError, match="CUDA or CPU"):
        call("meta")


@pytest.mark.parametrize("script", [plo, ppo, pgc])
def test_scripts_need_cuda_unless_asked_for_the_cpu(monkeypatch, capsys, script):
    """Without a card a probe script raises; with ``--device=cpu`` it runs
    (small constants) and prints one JSON line naming the device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main([])
    for k, v in PORT_STEP.items():
        monkeypatch.setattr(plo, k, v)
    for k, v in GRID.items():
        monkeypatch.setattr(pgc, k, v)
    monkeypatch.setattr(plo, "N_CHAIN", 2)
    monkeypatch.setattr(ppo, "IR_CONFIGS", ((8, 16, 6, 24, 2),))
    monkeypatch.setattr(ppo, "IR_BATCH", 1)
    monkeypatch.setattr(ppo, "ITERS", 1)
    assert script.main(["--device=cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu"


def test_ir_costs_use_the_h100_peaks():
    """The first TPU configuration at batch 64: minimal traffic 92.3 MB over
    3.35 TB/s bounds it (the operations, 16.9 GFLOP, take 17 us at 989
    TFLOP/s)."""
    c = ppo.ir_costs(256, 16, 6, 24, 2, 64)
    assert c["minimal_bytes"] == 64 * 256 * 256 * 2 * (16 + 24 / 4)
    assert c["bound_ms"] == pytest.approx(1e3 * c["minimal_bytes"] / 3.35e12)
    assert c["flops"] / 989e12 < c["minimal_bytes"] / 3.35e12
