"""Build the port's CUDA kernels, load them, and the launch helpers their
wrappers share.

Each library in ``LIBRARIES`` compiles one ``csrc/<source>.cu`` with ``nvcc``
(and the library's own extra flags) into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds). Libraries go to ``fpn_mt_image_captioning_torch/build/`` under a
name that carries the hash of the sources and flags, so an edited source
rebuilds and an unchanged one is reused. Nothing builds at import: the first
kernel launch builds what it needs, and ``build()`` builds everything at once,
one ``nvcc`` per library, all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

__all__ = ["LIBRARIES", "MAX_SMEM", "build", "load_library", "on_cpu", "check", "stream",
           "launched"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# library: (source in csrc/, extra nvcc flags)
LIBRARIES = {
    "fused_decoder": ("fused_decoder", ()),
    "fused_backbone": ("fused_backbone", ()),
    "probes": ("probes", ()),
    # the decode step's kernels with empty bodies, for the launch-cost probe
    "fused_decoder_trivial": ("fused_decoder", ("-DFD_TRIVIAL_BODIES",)),
    # the wgmma linear stamping its phases, for scripts/linear_phases.py
    "fused_decoder_phases": ("fused_decoder", ("-DFD_PHASE_TIMES",)),
}
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


def _command(name: str) -> list[str]:
    source, extra = LIBRARIES[name]
    return [*FLAGS, *extra, str(CSRC / f"{source}.cu")]


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(_command(name)[:-1]).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{LIBRARIES[name][0]}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(LIBRARIES)) -> dict[str, Path]:
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
            cmd = [nvcc, "-o", str(tmp), *_command(n)]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for n, (p, tmp) in procs.items():
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{n} (exit {p.returncode}):\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, todo[n])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return targets


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build((name,))[name]))


# ---------------------------------------------------------------------------
# what every kernel wrapper does around its launch
# ---------------------------------------------------------------------------
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version); False for a CUDA
    tensor (launch the kernel); raises for any other device."""
    if t.is_cpu:
        return True
    if not t.is_cuda:
        raise ValueError(f"kernels run on CUDA or CPU tensors, not {t.device}")
    return False


def check(name: str, t: torch.Tensor, shape, dtype, device: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    CUDA device ``device``. (Runs on every launch: its fast path reads no
    ``torch.device`` object, which costs more than the rest together.)"""
    if not (t.dtype == dtype and t.shape == shape and t.get_device() == device
            and t.is_contiguous()):
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape {tuple(shape)} on "
            f"cuda:{device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ', not contiguous'}")


def stream(device: int) -> int:
    """PyTorch's current stream on CUDA device ``device`` as a raw handle
    (the call Triton's launcher uses; no Stream object is built per launch).
    Inside ``torch.cuda.graph`` it is the capture stream."""
    return torch._C._cuda_getCurrentRawStream(device)


def launched(wrapper, rc: int, error_string) -> None:
    """Count one launch of ``wrapper``'s kernel, or raise with the library's
    ``error_string(rc)`` when the entry point returned an error code."""
    if rc != 0:
        raise RuntimeError(f"{wrapper.__name__}: {error_string(rc).decode()} (code {rc})")
    wrapper.launches += 1
