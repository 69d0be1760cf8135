"""What one kernel launch costs the port on the card, slope-measured: the
counterpart of the TPU probe ``scripts/probe_launch_overhead.py``.

Chains of N launches run back to back on one stream (stream order is the
dependency); the cost per link is the slope ``(t(2N) - t(N)) / N``, N = 96,
so the wait for the card and Python's call cancel. Variants:

  A  ``add_one``: one (256, 256) float32 operand, one launch (TPU variant A);
  B  ``add_one_grid7``: seven blocks, block 0 working (TPU variant B);
  C  the port's decode step on kernels with empty bodies
     (``ops.probes.probe_step``: 68 launches at the flagship shapes through
     ``fused_decode_step``'s own wrappers, checks, allocations and entry
     points, on the ``fused_decoder_trivial`` build), the self-attention
     launches also checking the TPU's one-hot operand (4, Lpad, 128, 128),
     which the port does not have;
  D  C with 8 real ``decoder_linear`` launches at the FFN shape
     (512 × 512 → 2048) in each layer (TPU ``compute_dots=8``): does a
     trivial launch's cost hide behind real kernels;
  E  C without the one-hot operand (TPU ``with_oh=False``): the port's own
     step exactly;

and C, D and E again as a ``torch.cuda.CUDAGraph`` captured once and
replayed (a replay launches the same kernels without the Python wrappers).
Each prints the host µs per link (wall clock) and, on the card, the device
µs per launch and per link (CUDA profiler).

    python -m fpn_mt_image_captioning_torch.scripts.probe_launch_overhead [--device=cpu] [A|B|C|D|E]
"""

from __future__ import annotations

import json
import sys

import torch

from ..ops import fused_decoder as fd
from ..ops import probes as pr
from ._common import device_from_argv, device_rows, slope, slope_links, sync, total

N_CHAIN = 96
D, DFF, V, LPAD, LENC, B_ITEMS, NL, H, BEAM, TILE = 512, 2048, 2000, 64, 16, 64, 6, 8, 8, 128
COMPUTE_DOTS = 8


def variant_a(device):
    """Runner factory: ``make(n)()`` adds one n times to (256, 256) zeros and
    returns the sum (65536·n)."""
    return _add_one_chain(pr.add_one, device)


def variant_b(device):
    return _add_one_chain(pr.add_one_grid7, device)


def _add_one_chain(kernel, device):
    def make(n):
        x0 = torch.zeros((256, 256), dtype=torch.float32, device=device)

        def run():
            x = x0
            for _ in range(n):
                x = kernel(x)
            return x.sum()

        return run

    return make


def step_setup(device, with_oh: bool = True, compute_dots: int = 0) -> dict:
    """``ops.probes.step_setup`` at the module's shapes (BK = B_ITEMS·BEAM
    rows)."""
    return pr.step_setup(b_items=B_ITEMS, beam=BEAM, d=D, num_heads=H, dff=DFF, vocab=V,
                         num_layers=NL, lpad=LPAD, lenc=LENC, with_oh=with_oh, tile=TILE,
                         compute_dots=compute_dots, device=device)


def variant_c(device, compute_dots: int = 0, with_oh: bool = True):
    """Runner factory: ``make(n)()`` runs n decode steps of trivial launches
    and returns the last step's top-k scores
    (``probe_step_reference(scores, BEAM)``)."""
    s = step_setup(device, with_oh, compute_dots)

    def make(n):
        def run():
            for _ in range(n):
                tops = pr.probe_step(s)
            return tops

        return run

    return make


def capture_step(s: dict):
    """One step captured into a CUDA graph (after one eager step, which
    builds and loads the kernels): ``(graph, tops)``, tops rewritten by every
    replay. The wrappers launch on the current stream, which inside
    ``torch.cuda.graph`` is the capture stream."""
    pr.probe_step(s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        tops = pr.probe_step(s)
    return graph, tops


def variant_c_graph(device, compute_dots: int = 0, with_oh: bool = True):
    """``variant_c`` replayed from one captured graph."""
    graph, tops = capture_step(step_setup(device, with_oh, compute_dots))

    def make(n):
        def run():
            for _ in range(n):
                graph.replay()
            return tops

        return run

    return make


def step_launches(compute_dots: int = 0) -> int:
    """Kernel launches of one step: 11 a layer, the vocabulary linear and the
    top-k, plus ``compute_dots`` real linears a layer."""
    return (11 + compute_dots) * NL + 2


# letter: (name, runner factory, real linears a layer; None for a single launch)
VARIANTS = {
    "A": ("A trivial", variant_a, None),
    "B": ("B grid7", variant_b, None),
    "C": ("C decoder-shaped", variant_c, 0),
    "D": ("D compute-overlap", lambda dev: variant_c(dev, compute_dots=COMPUTE_DOTS),
          COMPUTE_DOTS),
    "E": ("E no-oh", lambda dev: variant_c(dev, with_oh=False), 0),
}
GRAPHS = {"C": {}, "D": {"compute_dots": COMPUTE_DOTS}, "E": {"with_oh": False}}


def measure_one(make, launches: int, device, kernels: str = "") -> dict:
    """Host µs per link (slope over N_CHAIN and 2·N_CHAIN links) and, on the
    card, device µs per link and per launch (CUDA profiler over one chain of
    N_CHAIN links) of the kernels whose names hold ``kernels`` (A's and B's
    chains end in a sum, which this leaves out)."""
    k = N_CHAIN
    host = slope(make, k, device)
    row = {"host_us_per_link": host * 1e6, "launches_per_link": launches,
           "host_us_per_launch": host * 1e6 / launches}
    rows, windows = device_rows(make(k), device, k * launches, kernels)
    if rows is not None:
        us, n = total(rows, kernels)
        row.update(device_us_per_link=us / k, device_launches_per_link=n / k,
                   device_us_per_launch=us / n, profiler_windows=windows)
    return row


def expected_launches(results: dict) -> dict:
    """Launches of each kernel wrapper in the ``measure()`` on the card that
    gave ``results`` (every variant): each variant's chains
    (``slope_links``), plus two eager steps per graph (the warm-up and the
    capture). A replay runs no wrapper, so it counts nothing."""
    links = {letter: slope_links(N_CHAIN, results[name]["profiler_windows"])
             for letter, (name, _, _) in VARIANTS.items()}
    td = pr.TRIVIAL_DECODER
    per_step = {td.decoder_linear: 6 * NL + 1, td.decoder_add_layernorm: 3 * NL,
                td.decoder_self_attention: NL, td.decoder_cross_attention: NL,
                td.decoder_logsoftmax_topk: 1}
    steps = sum(links[letter] + 2 for letter in GRAPHS)
    return {pr.add_one: links["A"], pr.add_one_grid7: links["B"],
            **{k: n * steps for k, n in per_step.items()},
            fd.decoder_linear: COMPUTE_DOTS * NL * (links["D"] + 2)}


def measure(device=None, only: str | None = None) -> dict:
    """Every variant (or those whose letter is ``only``); C, D and E also
    replayed from a CUDA graph on the card (keys "C graph", ...)."""
    device = torch.device(device) if device is not None else device_from_argv([])[0]
    out = {}
    for letter, (name, factory, dots) in VARIANTS.items():
        if only and letter not in only:
            continue
        launches, kernels = (1, "add_one") if dots is None else (step_launches(dots), "")
        out[name] = measure_one(factory(device), launches, device, kernels)
        if letter in GRAPHS and device.type == "cuda":
            make = variant_c_graph(device, **GRAPHS[letter])
            out[f"{name} graph"] = measure_one(make, launches, device)
        sync(device)
    return out


def main(argv=None) -> int:
    device, rest = device_from_argv(sys.argv[1:] if argv is None else argv)
    results = measure(device, only="".join(rest) or None)
    for name, row in results.items():
        dev = row.get("device_us_per_launch")
        print(f"{name:26s} {row['host_us_per_link']:10.1f} us/link host "
              f"({row['host_us_per_launch']:.2f} us/launch), device "
              + (f"{dev:.2f} us/launch" if dev is not None else "not measured"), flush=True)
    print(json.dumps({"device": str(device), "launch_overhead": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
