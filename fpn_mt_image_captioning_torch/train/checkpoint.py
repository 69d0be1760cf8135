"""Checkpoints of the port and the CIDEr-gated smart saver (port of
``fpn_mt_image_captioning_tpu/train/checkpoint.py``).

``CheckpointManager`` has the JAX manager's interface (``latest_step``,
``save``, ``restore``, ``all_steps``, ``close``, ``max_to_keep`` pruning of
the oldest steps) over files of the port's own: one Flax msgpack file of the
training-state tree (``weights.train_state_to_flax``: the JAX ``TrainState``
layout) per step directory, ``<directory>/<step>/train_state.msgpack``,
written to a temporary name and renamed, so a step directory holds a whole
file or none. Over several ranks a save is collective: every rank calls it
with the whole tree (``Pipeline.state_tree`` gathers the tensor-parallel
shards), the primary writes, and every rank meets at a barrier after it; a
restore reads the whole tree on every rank, which keeps its shards
(``Pipeline.load_state_tree``). The JAX package's checkpoints are Orbax
stores (OCDBT + zstd), which the port does not read: a directory holding one
raises, and never starts afresh in its place.

``SmartCheckpointSaver`` is the JAX state machine unchanged:

  * save only when validation accuracy (CIDEr) improves;
  * while ``epoch <= min_epoch_to_break`` a non-improving epoch *resets* the
    baseline instead of counting against it;
  * signal early stop (-1) once
    ``min(epochs, max(min_epoch_to_break, 2·best_epoch), best_epoch + gap)``
    ≤ current epoch;
  * ``best_saved_step``: the step of the best metric among the checkpoints
    actually saved.
"""

from __future__ import annotations

import os
import shutil
from collections.abc import Mapping
from typing import Any

import numpy as np

from ..parallel.multihost import barrier, is_primary
from ..weights import read_flax_msgpack, write_flax_msgpack

__all__ = ["CheckpointManager", "SmartCheckpointSaver", "STATE_FILE"]

STATE_FILE = "train_state.msgpack"
_ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "default", "_METADATA", "manifest.ocdbt")


def _leaves(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _structure(tree) -> list:
    return [path for path, _ in _leaves(tree)]


def _differing_leaves(got, want) -> list:
    """(path, shapes, dtypes) of the leaves of two trees of one structure
    whose shape or dtype differ."""
    out = []
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            out.append(("/".join(path), a.shape, b.shape, str(a.dtype), str(b.dtype)))
    return out


class CheckpointManager:
    """Training-state trees (nested dicts of numpy arrays) by step."""

    def __init__(self, directory: str, max_to_keep: int = 100):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self.all_steps()   # refuses a directory of Orbax checkpoints here

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), STATE_FILE)

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if not (name.isdigit() and os.path.isdir(full)):
                continue
            inside = os.listdir(full)
            if any(marker in inside for marker in _ORBAX_MARKERS):
                raise NotImplementedError(
                    f"{full!r} is an Orbax checkpoint of the JAX package; reading Orbax "
                    "checkpoints is not ported (ROADMAP A.2). Export its weights with the "
                    "JAX package's Pipeline.save_weights, or give the port a checkpoint "
                    "directory of its own")
            if STATE_FILE in inside:
                steps.append(int(name))
        return sorted(steps)

    @property
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Mapping) -> None:
        if is_primary():
            os.makedirs(os.path.dirname(self._path(step)), exist_ok=True)
            tmp = self._path(step) + ".tmp"
            write_flax_msgpack(tmp, state)
            os.replace(tmp, self._path(step))
            for old in self.all_steps()[: -self.max_to_keep or None]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        barrier("checkpoint_save")

    def restore(self, state_template: Mapping, step: int | None = None) -> Any:
        """The tree saved at ``step`` (default: the latest; None when there
        is none), checked against ``state_template``. A tree that differs in
        ``opt_state`` only (an older optimizer format) restores ``params``,
        ``batch_stats`` and ``step`` and takes ``opt_state`` from the
        template, loudly; any other difference raises ``ValueError``."""
        step = self.latest_step if step is None else step
        if step is None:
            return None
        raw = read_flax_msgpack(self._path(step))
        if not isinstance(raw, Mapping) or set(raw) != set(state_template):
            raise ValueError(f"checkpoint step {step}: fields {sorted(raw)} are not "
                             f"{sorted(state_template)}")
        for f in state_template:
            if f == "opt_state":
                continue
            if _structure(raw[f]) != _structure(state_template[f]):
                raise ValueError(
                    f"checkpoint step {step}: field {f!r} structure does not match the live "
                    "model — not a plain optimizer-format drift, refusing partial restore")
            bad = _differing_leaves(raw[f], state_template[f])
            if bad:
                raise ValueError(f"checkpoint step {step}: field {f!r} leaf shapes/dtypes "
                                 f"differ from the live model: {bad[:3]}")
        opt, want = raw["opt_state"], state_template["opt_state"]
        if _structure(opt) == _structure(want) and not _differing_leaves(opt, want):
            return dict(raw)
        print(f"WARNING: checkpoint step {step} stores an optimizer state from an older "
              "optimizer format; restored params/batch_stats/step and REINITIALIZED "
              "opt_state (momenta reset — expect a brief warmup transient).")
        return {**raw, "opt_state": want}

    def close(self) -> None:
        """Nothing to release (the JAX manager stops Orbax's threads)."""


class SmartCheckpointSaver:
    """CIDEr-gated checkpoint/early-stop state machine (reference parity)."""

    def __init__(self, ckpt_manager, epochs: int = 100,
                 min_epoch_to_break: int | None = None, gap_of_dead_epoch: int = 25):
        self.ckpt_manager = ckpt_manager
        self.epochs = epochs
        # None → epochs // 2, as Config.min_epoch_to_break
        self.min_epoch_to_break = (
            epochs // 2 if min_epoch_to_break is None else min_epoch_to_break
        )
        self.gap_of_dead_epoch = gap_of_dead_epoch
        self.max_val_acc = -np.inf
        self.max_acc_epoch = 0
        # the step holding the best metric among checkpoints actually saved:
        # the early-epoch baseline resets move max_acc_epoch without a save,
        # so a later save can sit at a higher step with a worse metric
        self.best_saved_step: int | None = None
        self.best_saved_acc = -np.inf

    def __call__(self, curr_epoch: int, curr_val_acc: float, state: Any = None) -> int:
        """Returns 1 = checkpoint saved, 0 = nothing, -1 = early-stop signal.
        ``state``: the tree to save, or a callable that makes it (called only
        when a save happens)."""
        if self.max_acc_epoch == 0:
            self.max_val_acc = curr_val_acc
            self.max_acc_epoch = curr_epoch

        if curr_val_acc > self.max_val_acc:
            if state is not None:
                self.ckpt_manager.save(curr_epoch, state() if callable(state) else state)
                print(f"Saving checkpoint for epoch {curr_epoch} at {self.ckpt_manager.directory}")
                if curr_val_acc > self.best_saved_acc:
                    self.best_saved_acc = curr_val_acc
                    self.best_saved_step = curr_epoch
            self.max_val_acc = curr_val_acc
            self.max_acc_epoch = curr_epoch
            return 1
        elif curr_epoch <= self.min_epoch_to_break:
            # early epochs: reset the baseline rather than counting toward death
            self.max_val_acc = curr_val_acc
            self.max_acc_epoch = curr_epoch
        else:
            epoch_min = min(
                self.epochs,
                max(self.min_epoch_to_break, int(self.max_acc_epoch * 2.0)),
                int(self.max_acc_epoch + self.gap_of_dead_epoch),
            )
            if epoch_min <= curr_epoch:
                return -1
        return 0
