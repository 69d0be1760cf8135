"""Multi-process wiring over ``torch.distributed`` (port of
``fpn_mt_image_captioning_tpu/parallel/multihost.py``).

One process drives one card. A run is launched by ``python -m
torch.distributed.run --nproc_per_node=N`` or by the same environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``). ``maybe_initialize()`` reads it at entry and brings up the
default process group: NCCL on the card, gloo when the caller asks for the
CPU (or the backend it names); a rank's device is ``cuda:LOCAL_RANK``.

  * ``process_shard()`` — ``(rank, world size)``: the input pipeline's
    corpus shard (``data/dataset.py`` applies it);
  * ``is_primary()`` — rank 0 writes the result files, logs and
    checkpoints;
  * ``globalize_batch(mesh, local)`` — this rank's data share: the rows of
    every rank of its model group, concatenated in rank order (the global
    batch is the concatenation of every rank's local rows);
    ``localize_rows`` is its inverse;
  * ``gather_rows(local)`` — every rank's rows, concatenated in rank order,
    on every rank (exact for any dtype: the rows travel pickled);
  * ``barrier(name)`` — every rank meets, with a timeout.

Without that environment (and without a process group set up by the caller)
every function is the identity of one process: ``(0, 1)``, True, the rows
themselves.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch

__all__ = ["maybe_initialize", "process_shard", "is_primary", "globalize_batch",
           "localize_rows", "gather_rows", "barrier", "aligned_call", "world_size", "rank",
           "local_rank", "LAUNCH_ENV"]

LAUNCH_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
TIMEOUT_S = 600.0


def _dist():
    """``torch.distributed`` once a process group is up, else None."""
    d = torch.distributed
    return d if d.is_available() and d.is_initialized() else None


def world_size() -> int:
    d = _dist()
    return d.get_world_size() if d else 1


def rank() -> int:
    d = _dist()
    return d.get_rank() if d else 0


def local_rank() -> int:
    """The card this process drives: ``LOCAL_RANK`` (0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def maybe_initialize(device=None, backend: str | None = None,
                     timeout_s: float = TIMEOUT_S) -> bool:
    """Bring up the default process group from the launcher's environment.
    ``device``: ``"cpu"`` selects gloo; otherwise NCCL, with this process on
    ``cuda:LOCAL_RANK``; ``backend`` overrides the choice. Returns False (and
    does nothing) without the environment; idempotent."""
    d = torch.distributed
    if _dist() is not None:
        return True
    if not all(os.environ.get(k) for k in LAUNCH_ENV):
        return False
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if backend is None:
        backend = "gloo" if on_cpu else "nccl"
    if not on_cpu and torch.cuda.is_available():
        torch.cuda.set_device(local_rank())
    d.init_process_group(backend, init_method="env://",
                         timeout=datetime.timedelta(seconds=timeout_s))
    return True


def barrier(name: str, timeout_s: float = TIMEOUT_S) -> None:
    """Every rank meets here (``name`` is for the reader of a timeout's
    message); raises after ``timeout_s``. No-op in one process."""
    d = _dist()
    if d is None or d.get_world_size() == 1:
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    if d.get_backend() == "gloo":
        d.monitored_barrier(timeout=timeout, wait_all_ranks=True)
    else:
        d.barrier(device_ids=[torch.cuda.current_device()])


def aligned_call(fn, name: str, cache: dict, *args):
    """``fn(*args)``. The JAX package compiles a collective program ahead
    and meets at a barrier before its first run, because its CPU collectives
    must rendezvous inside a fixed window; PyTorch runs eagerly and its
    process groups have no such window, so the port needs no alignment."""
    del name, cache
    return fn(*args)


def process_shard() -> tuple[int, int]:
    """(shard index, shard count) of the input pipeline."""
    return rank(), world_size()


def is_primary() -> bool:
    """True on the rank that writes user-facing files (rank 0)."""
    return rank() == 0


def gather_rows(local_rows) -> np.ndarray:
    """Every rank's ``local_rows`` concatenated along axis 0 in rank order,
    on every rank. Any dtype travels exactly (int64 image ids, float64
    scores); a 0-d value is one row, so a shared scalar comes back with
    shape ``(world size,)``. The identity in one process."""
    arr = np.asarray(local_rows)
    if arr.ndim == 0:
        arr = arr[None]
    d = _dist()
    if d is None or d.get_world_size() == 1:
        return arr
    parts = [None] * d.get_world_size()
    d.all_gather_object(parts, arr)
    return np.concatenate(parts)


def globalize_batch(mesh, local: torch.Tensor) -> torch.Tensor:
    """This rank's data share of the global batch: the local rows of every
    rank of its model group, concatenated in rank order (all ranks of a
    model group must hold the same number of rows). ``local`` itself
    without a mesh or with a model axis of one."""
    from .collectives import gather_shards
    from .mesh import model_group

    with torch.no_grad():
        return gather_shards(local, model_group(mesh), 0)


def localize_rows(rows, mesh):
    """Inverse of ``globalize_batch``: this rank's own rows of its data
    share (the model-axis index picks its part)."""
    from .mesh import axis_index, axis_size

    m = axis_size(mesh, 1)
    if m == 1:
        return rows
    n = rows.shape[0] // m
    i = axis_index(mesh, 1)
    return rows[i * n:(i + 1) * n]
