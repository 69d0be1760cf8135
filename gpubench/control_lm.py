"""The readings that the limits of a cell whose decoder is a language model
(``drivers/caption_lm.py``) are set from: the captioner's own (sound runs,
over many seeds), the faults' (``faults_lm.py``) and the control's (the
reference put in the captioner's place and computed in float8, the
precision below the configuration's bfloat16), each the number
``judge.py`` compares, taken against the float32 reference.

    python3 gpubench/control_lm.py --workload kimivl.caption_b256 --seeds 11,12,13 \\
        [--control-seeds 11] [--seconds 3]

prints one JSON line a seed. Every seed sets the cell up as ``run.py`` does
and drives a window of ``--seconds``; the seeds of ``--control-seeds`` (all,
by default) then drive one more window under each fault. The pipeline is
released before any reference is built (the language model's weights and
the reference's would not both fit the card), so every window's calls are
judged after the last one. The control encodes and beam-searches
``check_images`` images of the cell's pool. The benchmark's own runs do not
run this."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from gpubench import faults, faults_lm, harness, inputs, inputs_lm, judge, run  # noqa: E402
from gpubench.drivers import caption_lm  # noqa: E402
from gpubench.reference import decode as ref_decode  # noqa: E402
from gpubench.reference.numerics import NUMERICS  # noqa: E402


def readings(files: dict, seed: int, device, numerics: str = "fp8", seconds: float = 3.0,
             control: bool = True) -> dict:
    import numpy as np
    import torch
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

    r = caption_lm.Run(files["config"], files["traffic"], seed, device)
    r.setup()
    r.window(seconds)
    windows = {"program": (r.outputs, r.kept)}
    for fault in faults_lm.CAPTION_LM if control else ():
        planted = faults.Planted()
        fault(Pipeline, planted.setattr)
        try:
            r.window(seconds)
        finally:
            planted.undo()
        windows[fault.__name__] = (r.outputs, r.kept)
    r.release()
    out = {}
    for name, (r.outputs, r.kept) in windows.items():
        out[name] = r.check()
    if not control:
        return out
    t, cfg = r.traffic, r.cfg
    rng = np.random.default_rng(inputs.subseed(r.seed, 1001))
    flat = rng.choice(len(r.pool) * t["batch"], t["check_images"], replace=False)
    images = torch.as_tensor(np.stack([r.pool[i // t["batch"]][i % t["batch"]] for i in flat]),
                             device=device)
    ref = r.reference()
    ctl = inputs_lm.reference(cfg, ref.state_dict(), device, NUMERICS[numerics])
    beam, end = cfg["beam_search_n"], caption_lm.END
    with torch.no_grad():
        enc = ctl.encode(images)
        seqs, scores, _ = ref_decode.beam_search(ctl, enc, beam, r.max_len, caption_lm.START, end)
    best, scores = seqs[:, 0], scores[:, 0]
    ended = best == end
    lengths = torch.where(ended.any(1), ended.int().argmax(1), r.max_len).int()
    best = torch.where(torch.arange(r.max_len, device=device)[None] < lengths[:, None], best, 0)
    out["control"], _ = judge.caption_numbers(ref, images, enc, best, lengths, scores, beam=beam,
                                              max_len=r.max_len, start=caption_lm.START, end=end)
    return out


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default=None)
    p.add_argument("--seconds", type=float, default=3.0)
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
        harness.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
