"""ctypes binding for the native C++ image loader (``runtime/image_loader.cc``,
the port's copy of the JAX package's loader: PNG, PPM and PGM decode,
half-pixel bilinear resize, [-1, 1] scaling, a thread pool per batch).

The shared object builds on first use with ``g++ -O3`` (linked against zlib)
into the port's git-ignored ``build/`` directory, under a name that carries
the hash of the source and flags. The build is atomic: it compiles to a
temporary file and ``os.replace``s it into place while holding a file lock,
so several processes (test workers, server threads) that load images at once
build it once and never load a half-written library. ``available()`` is
False when the toolchain or zlib is missing; callers then decode with PIL.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "decode_batch", "library_path"]

_SRC = Path(__file__).resolve().with_name("image_loader.cc")
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-lz", "-lpthread")

_lock = threading.Lock()
_lib = None
_failed = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS + _LIBS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"_image_loader-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> bool:
    """Compile ``target`` unless another process already has; True when it
    exists afterwards."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "_image_loader.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.is_file():            # built while this process waited
            return True
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp), *_LIBS]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=240)
            os.replace(tmp, target)
            return True
        except (subprocess.SubprocessError, OSError):
            tmp.unlink(missing_ok=True)
            return False


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        target = library_path()
        try:
            if not target.is_file() and not _build(target):
                _failed = True
                return None
            lib = ctypes.CDLL(str(target))
        except OSError:
            _failed = True
            return None
        lib.fpnmt_decode_batch.restype = ctypes.c_int
        lib.fpnmt_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8), ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def decode_batch(paths: list[str], size: int, num_threads: int | None = None):
    """Returns (images (N, S, S, 3) float32 in [-1, 1], ok (N,) bool); rows of
    files that fail to decode are zero."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native image loader unavailable")
    n = len(paths)
    out = np.empty((n, size, size, 3), dtype=np.float32)
    ok = np.zeros(n, dtype=np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    threads = num_threads or min(16, os.cpu_count() or 1)
    lib.fpnmt_decode_batch(
        c_paths, n, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        threads,
    )
    return out, ok.astype(bool)
