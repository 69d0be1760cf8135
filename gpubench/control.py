"""The readings that each cell's limits are set from: the captioner's own
(sound runs, over many seeds), the control's (the reference put in the
captioner's place and computed in float8, the precision below the
configuration's bfloat16) and the faults'. Each reading is the number
``judge.py`` compares, taken against the float32 reference.

    python3 gpubench/control.py --workload <cell> --seeds 11,12,13 [--control-seeds 11]

prints one JSON line a seed. Every seed runs the cell as ``run.py`` does,
with a window of ``--seconds``, and reads the captioner's numbers; the seeds
of ``--control-seeds`` (all, by default) also read the control and the
faults. The benchmark's own runs do not run this.

* Captioning: after the sound window, a second window with the top-k of
  every decode step skipping each row's best candidate
  (``faults.topk_skips_best``), judged as a run is; then the control's
  encode and beam search over ``check_images`` images of the cell's pool.
* Training: the control's first three steps and its step from the
  captioner's state after the window; the fault of a step that leaves half
  of the batch out (the reference on the first half of each batch, the
  mean over those rows). A step that returns its state unchanged reads
  ``change_gap``, ``leaf_change_gap`` and ``window_change_gap`` 1 by
  construction (so does a leaf left unmoved, for ``leaf_change_gap``), and
  is printed so.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from gpubench import faults, harness, inputs, judge, run  # noqa: E402
from gpubench.reference import decode as ref_decode  # noqa: E402
from gpubench.reference.numerics import NUMERICS  # noqa: E402


def caption_readings(r, numerics, seconds: float, control: bool) -> dict:
    """``r``: the cell's caption ``Run``."""
    import numpy as np
    import torch
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

    r.setup()
    r.window(seconds)
    flags = _tf32()
    out = {"program": r.check()}
    if not control:
        r.release()
        return out
    planted = faults.Planted()
    faults.topk_skips_best(Pipeline, planted.setattr)
    try:
        _tf32(flags)     # the reference turned TF32 off; the captioner runs as it was
        r.window(seconds)
        out["topk_skips_best"] = r.check()
    finally:
        planted.undo()
    r.release()
    t, cfg = r.traffic, r.cfg
    rng = np.random.default_rng(inputs.subseed(r.seed, 1001))
    flat = rng.choice(len(r.pool) * t["batch"], t["check_images"], replace=False)
    images = torch.as_tensor(np.stack([r.pool[i // t["batch"]][i % t["batch"]] for i in flat]),
                             device=r.device)
    ctl = harness.reference(cfg, r.vocab, r.state, r.device, numerics)
    with torch.no_grad():
        enc = ctl.encode(images)
        seqs, scores, _ = ref_decode.beam_search(ctl, enc, cfg["beam_search_n"], r.max_len, 2, 3)
    best, scores = seqs[:, 0], scores[:, 0]
    ended = best == 3
    lengths = torch.where(ended.any(1), ended.int().argmax(1), r.max_len).int()
    best = torch.where(torch.arange(r.max_len, device=r.device)[None] < lengths[:, None], best, 0)
    del ctl
    harness.free(r.device)
    ref = harness.reference(cfg, r.vocab, r.state, r.device)
    out["control"], _ = judge.caption_numbers(ref, images, enc, best, lengths, scores,
                                              beam=cfg["beam_search_n"], max_len=r.max_len,
                                              start=2, end=3)
    return out


def train_readings(r, numerics, seconds: float, control: bool) -> dict:
    """``r``: the cell's training ``Run``."""
    r.setup()
    r.window(seconds)
    r.release()
    ref = r.reference_readings()
    harness.free(r.device)
    wref = r.window_reference()
    harness.free(r.device)
    judged = lambda prog, wprog: {**judge.train_numbers(prog, ref),
                                  **judge.window_numbers(wprog, wref)}
    out = {"program": judged(r.program, r.after_window)}
    if not control:
        return out
    half = r.traffic["batch"] // 2
    for name, kw in (("control", {"numerics": numerics}), ("half_batch", {"rows": half})):
        prog = r.reference_readings(**kw)
        harness.free(r.device)
        wprog = r.window_reference(**kw)
        harness.free(r.device)
        out[name] = judged(prog, wprog)
    out["state_unchanged"] = dict.fromkeys(("change_gap", "leaf_change_gap",
                                            "window_change_gap"), 1.0)
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default=None)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--numerics", default="fp8", choices=sorted(NUMERICS))
    args = p.parse_args(argv)
    files = run.cell_files(args.workload)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    seeds = [int(s) for s in args.seeds.split(",")]
    with_control = set(seeds if args.control_seeds is None
                       else (int(s) for s in args.control_seeds.split(",")))
    for seed in seeds:
        out = readings(files, seed, device, args.numerics, args.seconds, seed in with_control)
        print(json.dumps({"seed": seed, **out}), flush=True)
    return 0


def _tf32(flags=None):
    """The process's TF32 settings; with ``flags``, set them back."""
    import torch

    if flags is not None:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def readings(files: dict, seed: int, device, numerics: str = "fp8", seconds: float = 2.0,
             control: bool = True) -> dict:
    """One seed's readings (see above); the process's TF32 settings are as
    they were after it, for the next seed's captioner."""
    traffic = files["traffic"]
    driver = importlib.import_module(f"gpubench.drivers.{traffic['driver']}")
    r = driver.Run(files["config"], traffic, seed, device)
    fn = caption_readings if traffic["driver"] == "caption_closed" else train_readings
    flags = _tf32()
    try:
        return fn(r, NUMERICS[numerics], seconds, control)
    finally:
        _tf32(flags)
        harness.free(device)


if __name__ == "__main__":
    sys.exit(main())
