"""Run one cell of the benchmark once, on the card it is started on:

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``: a configuration
(``gpubench/configs/<config>.json``), a traffic mix
(``gpubench/traffic/<traffic>.json``, whose ``driver`` names the code in
``gpubench/drivers/`` that generates it) and its limits
(``gpubench/workloads/<cell>.json``). The run builds the captioner and its
inputs from the seed (set-up), drives the window for ``--seconds``, and then
decides ``correct`` against the plain reference. With ``--trace 0`` it
reports the cell's end-to-end metrics; with ``--trace 1`` it measures the
layers after the window and reports the per-layer metrics, each read by its
reader in ``gpubench/metrics/<metric>.py``. The last line of standard output
is the result; the numbers compared with their limits are the last lines of
standard error.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 3 and prints no result. It exits with 4 if the process has loaded JAX
or the JAX package."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# one host thread for the CPU side of the run: the captioner's host work is
# one Python loop, and idle pool threads only contend for the host's cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level modules that must not be loaded: the benchmark measures the
# PyTorch port, never the JAX package beside it
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "fpn_mt_image_captioning_tpu")


def load(path: Path, name: str):
    """Import the file ``path`` as module ``name`` of the benchmark."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_files(workload: str, bench: dict | None = None) -> dict:
    """The cell's entry and the data of its configuration, traffic and limits."""
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    read = lambda *p: json.loads(HERE.joinpath(*p).read_text())
    return {"bench": bench, "cell": cell, "config": read("configs", f"{cell['config']}.json"),
            "traffic": read("traffic", f"{cell['traffic']}.json"),
            "limits": read("workloads", f"{workload}.json")["limits"]}


def metrics_of(bench: dict, workload: str, key: str) -> list[dict]:
    """The metrics of ``bench[key]`` that this cell reports: those whose
    ``workloads`` name it, and those without that key."""
    return [m for m in bench[key] if workload in m.get("workloads", (workload,))]


def banned_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def run_cell(files: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             t0: float = T0) -> dict:
    """Set up, drive and check one run; returns the result object."""
    import torch

    from gpubench import harness

    cfg, traffic = files["config"], files["traffic"]
    driver = importlib.import_module(f"gpubench.drivers.{traffic['driver']}")
    run = driver.Run(cfg, traffic, seed, device)
    run.setup()
    harness.sync(device)
    setup_s = harness.now() - t0
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    measured = run.window(seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    bench = files["bench"]
    if not trace:   # end-to-end metrics the run reads from a device trace
        measured["metrics"].update(run.device_metrics(
            {m["name"] for m in metrics_of(bench, workload, "end_to_end")}))
    traced = run.trace() if trace else None
    run.release()
    numbers = run.check()
    from gpubench import judge

    correct, checks = judge.verdict(numbers, files["limits"])
    if trace:
        metrics = {}
        for m in metrics_of(bench, workload, "per_layer"):
            value = load(HERE / "metrics" / f"{m['name']}.py", f"gpubench.metrics.{m['name']}"
                         ).read(run.measured)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(measured["metrics"], setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench, workload, "end_to_end")}
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": files["cell"]["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": measured["attempted"],
              "failed": measured["failed"], "metrics": metrics, "device": dev_info}
    if traced is not None:
        dev_info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
        result["breakdown"] = traced["breakdown"]
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    files = cell_files(args.workload)

    import torch

    chips = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(files, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    found = banned_modules()
    if found:
        print(f"gpubench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
