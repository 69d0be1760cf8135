"""A float64 witness for the step checks of tests/test_torch_parallel_world.py.

    JAX_PLATFORMS=cpu python tests/float64_witness.py [--start=seeded|step]

Runs the 3 training steps of those checks (the global batch of
``torch_world.train_batch``, dropout 0 and 0.1) from one start along every
route: the JAX package's jitted single-device step, the port in one process,
the port sharded over the worlds 2 × 1 and 2 × 2 (gloo), all float32; and the
port in one process in float64, from a copy of the package made in a
temporary directory with every float32 cast turned into float64 (the dropout
masks still drawn as float32, so the bits of the masks are the same). Prints,
for each float32 route, the distance of its Adam first moments from the
float64 ones and from the other float32 routes, as the checks measure it:
per tensor ``‖Δ‖ / (‖m‖ + 1e-3·max‖m‖)``, the median over tensors and the
worst tensor.

``--start=seeded`` (default) starts from the port's seeded init
(``init_weights``, the JAX package's initializer families);
``--start=step`` from the checks' own start (``torch_world.step_variables``).
A route no farther from float64 than the others is as right as float32
allows; a sharded route markedly farther than one process would be a fault
of the sharded path. Takes ~3 minutes on 4 CPU cores.
"""

import pickle
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))

F64_STEPS = r'''
import pickle, sys
sys.path.insert(0, sys.argv[3])
import torch_world as tw
for k in [k for k in sys.modules if k.startswith("fpn_mt_image_captioning_torch")]:
    del sys.modules[k]
sys.path.remove(str(tw.REPO))
sys.path.insert(0, sys.argv[4])
import numpy as np, torch
torch.set_default_dtype(torch.float64)
torch.set_num_threads(1)
import fpn_mt_image_captioning_torch as pkg
assert pkg.__file__.startswith(sys.argv[4]), pkg.__file__
from fpn_mt_image_captioning_torch.train.pipeline import Pipeline

def up(t):
    if isinstance(t, dict):
        return {k: up(v) for k, v in t.items()}
    a = np.asarray(t)
    return a.astype(np.float64) if a.dtype == np.float32 else t

start = pickle.load(open(sys.argv[1], "rb"))
tok = tw.tokenizer()
images, caps = tw.train_batch(len(tok.index_word))
out = {}
for dropout in (0.0, 0.1):
    pipe = Pipeline(tok, tw.MAX_LEN, tw.config(dropout, mesh=False), seed=0, device="cpu",
                    checkpoint_path=sys.argv[2] + f".ckpt{dropout}")
    pipe.load_state_tree(up(start))
    assert next(pipe.state.model.parameters()).dtype == torch.float64
    losses = [pipe.train_step(images, caps) for _ in range(tw.STEPS)]
    out[dropout] = dict(losses=losses, tree=pipe.state_tree())
pickle.dump(out, open(sys.argv[2], "wb"))
'''


def float64_copy(dst: Path) -> Path:
    """The port's package under ``dst`` with float32 casts made float64
    (``torch.float32``, ``.float()``, ``np.float32``); the dropout masks
    stay float32 draws."""
    src = HERE.parent / "fpn_mt_image_captioning_torch"
    pkg = dst / src.name
    shutil.copytree(src, pkg, ignore=shutil.ignore_patterns("__pycache__", "csrc", "*.jsonl"))
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        text = (text.replace("torch.float32", "torch.float64").replace(".float()", ".double()")
                .replace("np.float32", "np.float64"))
        path.write_text(text)
    layers = pkg / "models" / "layers.py"
    text, n = re.subn(r"torch\.rand\(\(total, \*x\.shape\[1:\]\), generator=self\.generator,",
                      "torch.rand((total, *x.shape[1:]), generator=self.generator, "
                      "dtype=torch.float32,", layers.read_text())
    assert n == 1, "the dropout draw moved: update float64_copy"
    layers.write_text(text)
    return dst


def distances(got: dict, want: dict) -> tuple[float, str, float]:
    import numpy as np

    gmax = max(np.linalg.norm(w) for w in want.values())
    errs = {k: float(np.linalg.norm(np.asarray(got[k], np.float64) - w)
                     / (np.linalg.norm(w) + 1e-3 * gmax)) for k, w in want.items()}
    worst = max(errs, key=errs.get)
    return float(np.median(list(errs.values()))), worst, errs[worst]


def main(argv) -> int:
    import numpy as np
    import torch

    start_kind = "seeded"
    for a in argv:
        if a.startswith("--start=") and a.split("=", 1)[1] in ("seeded", "step"):
            start_kind = a.split("=", 1)[1]
        else:
            raise SystemExit(f"unknown argument {a!r}")
    torch.set_num_threads(1)
    import test_torch_parallel_world as T
    import torch_world as tw
    from fpn_mt_image_captioning_torch.train.pipeline import Pipeline
    from fpn_mt_image_captioning_torch.weights import to_flax

    work = Path(tempfile.mkdtemp(prefix="float64_witness_"))
    try:
        tok = tw.tokenizer()
        inputs = T.make_inputs(work / "inputs", tok) if (work / "inputs").mkdir() is None else None
        (work / "worlds").mkdir()
        extra = ("seeded",) if start_kind == "seeded" else ()
        worlds = {n: T.World(n, work / "worlds", inputs["dir"], *extra) for n in T.WORLDS}
        variables = None if start_kind == "seeded" else tw.step_variables(tok)
        start = Pipeline(tok, tw.MAX_LEN, tw.config(mesh=False), variables, seed=0,
                         device="cpu", checkpoint_path=str(work / "start"))
        pickle.dump(start.state_tree(), open(work / "start.pkl", "wb"))
        (work / "f64_steps.py").write_text(F64_STEPS)
        f64 = subprocess.Popen([sys.executable, str(work / "f64_steps.py"),
                                str(work / "start.pkl"), str(work / "f64.pkl"), str(HERE),
                                str(float64_copy(work / "f64"))])
        images, caps = tw.train_batch(len(tok.index_word))
        one = {}
        for dropout in (0.0, 0.1):
            pipe = Pipeline(tok, tw.MAX_LEN, tw.config(dropout, mesh=False), variables, seed=0,
                            device="cpu", checkpoint_path=str(work / f"one{dropout}"))
            one[dropout] = [pipe.train_step(images, caps) for _ in range(tw.STEPS)], \
                pipe.state_tree()
        jx = T.jax_step_reference(tok, to_flax(start.state.model))
        if f64.wait() != 0:
            raise SystemExit("the float64 run failed")
        w64 = pickle.load(open(work / "f64.pkl", "rb"))

        def m(tree):
            return {k: np.asarray(v, np.float64)
                    for k, v in T.flat(tree["opt_state"]["1"]["m"]).items()}

        routes = {0.0: {"JAX": {k: np.asarray(v, np.float64) for k, v in jx["m"].items()},
                        "one process": m(one[0.0][1])},
                  0.1: {"one process": m(one[0.1][1])}}
        for n, w in worlds.items():
            for dropout in (0.0, 0.1):
                routes[dropout][f"sharded {n}"] = m(w.tree(f"step_dropout{dropout}"))
        print(f"start: {start_kind}; losses float64 {w64[0.0]['losses']}, one process "
              f"{one[0.0][0]}, JAX {jx['losses']}")
        for dropout, got in routes.items():
            ref = m(w64[dropout]["tree"])
            names = list(got)
            for i, a in enumerate(names):
                med, worst, we = distances(got[a], ref)
                print(f"dropout {dropout}: {a:14s} vs float64     median {med:.3e}  "
                      f"worst {we:.3e} ({worst})")
                for b in names[:i]:
                    med, worst, we = distances(got[a], got[b])
                    print(f"dropout {dropout}: {a:14s} vs {b:14s} median {med:.3e}  "
                          f"worst {we:.3e} ({worst})")
        for w in worlds.values():
            w.kill()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
