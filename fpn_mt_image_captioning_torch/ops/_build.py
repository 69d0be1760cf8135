"""Build the port's CUDA kernels and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library with
a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Libraries go to ``fpn_mt_image_captioning_torch/build/`` under
a name that carries the hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. Nothing builds at import: the first
kernel launch builds what it needs, and ``build()`` builds everything at once,
one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "build", "load_library"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("fused_decoder", "fused_backbone")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, all in
    parallel; returns the library paths. Raises with nvcc's output if a
    build fails."""
    targets = {n: _target(n) for n in names}
    todo = {n: t for n, t in targets.items() if not t.is_file()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, t in todo.items():
            tmp = t.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for n, (p, tmp) in procs.items():
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{n}.cu (exit {p.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build((name,))[name]))
