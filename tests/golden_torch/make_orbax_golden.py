"""The golden Orbax checkpoint ``tests/golden_torch/orbax/1``: a toy tree of
a few KB, written by the JAX package's ``CheckpointManager`` (Orbax, OCDBT,
zstd), that the port's reader (``train/orbax_store.py``) must read back to
the values ``golden_tree(SEED)`` regenerates with numpy alone: float32,
bfloat16 and int32 leaves, 0-d ones, and a leaf equal to its fill value
(all zeros). The CPU tests (``tests/test_torch_orbax.py``) and the card's
smoke (``chip_smoke.py``, phase 19) read it; the card has no Orbax.

    JAX_PLATFORMS=cpu python tests/golden_torch/make_orbax_golden.py

rewrites it (only this function imports JAX).
"""

from __future__ import annotations

import pathlib
import shutil

import numpy as np

SEED = 19
DIR = pathlib.Path(__file__).resolve().parent / "orbax"


def bfloat16_bits(x: np.ndarray) -> np.ndarray:
    """The bfloat16 nearest to float32 ``x`` (ties to even), as uint16 bit
    patterns: what a cast to bfloat16 gives."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    return rounded.astype(np.uint16)


def golden_tree(seed: int = SEED) -> dict:
    """The tree, bfloat16 leaves as their uint16 bit patterns."""
    rng = np.random.default_rng(seed)
    return {"params": {"dense": {"kernel": rng.standard_normal((16, 8)).astype(np.float32),
                                 "bias": rng.standard_normal(8).astype(np.float32)},
                       "embedding": bfloat16_bits(rng.standard_normal((12, 4)))},
            "counts": rng.integers(-1000, 1000, 5).astype(np.int32),
            "step": np.array(7, np.int32), "scale": np.array(0.125, np.float32),
            "zeros": np.zeros(6, np.float32)}


def main() -> None:
    import jax.numpy as jnp

    from fpn_mt_image_captioning_tpu.train.checkpoint import CheckpointManager

    tree = golden_tree()
    tree["params"]["embedding"] = jnp.asarray(tree["params"]["embedding"].view(jnp.bfloat16))
    shutil.rmtree(DIR, ignore_errors=True)
    mgr = CheckpointManager(str(DIR))
    mgr.save(1, tree)
    mgr.close()


if __name__ == "__main__":
    main()
