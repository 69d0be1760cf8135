"""The benchmark measures the PyTorch port and nothing else: no module under
``gpubench/`` imports JAX or the JAX package, none reads the JAX package's
benchmark files, and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

GPUBENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "fpn_mt_image_captioning_tpu"}
PORT = "fpn_mt_image_captioning_torch"
SOURCES = sorted(GPUBENCH.rglob("*.py"))


def imported(path: Path) -> set[str]:
    """Top-level names of the absolute imports of ``path``; relative imports
    as ``.``-prefixed module paths."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                names.add("." * node.level + (node.module or ""))
            else:
                names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(GPUBENCH)))
def test_no_jax(path):
    assert not imported(path) & BANNED


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(GPUBENCH)))
def test_no_jax_benchmark_files(path):
    text = path.read_text()
    for name in ("benchmarks/", "bench.py", "chip_smoke"):
        assert name not in text or path.parent.name == "tests"


@pytest.mark.parametrize("path", sorted((GPUBENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_is_plain(path):
    """The reference imports torch, numpy and the standard library, and
    within the benchmark only its own modules."""
    names = imported(path)
    assert PORT not in names
    assert not {n for n in names if n.startswith("..")}
    assert not {n for n in names if not n.startswith(".")} - {"torch", "numpy", "math", "hashlib",
                                                              "__future__"}


def test_the_port_is_not_the_jax_package():
    """Names are compared whole: the port's name begins with the JAX
    package's stem and is not banned."""
    from gpubench import run

    sys.modules["fpn_mt_image_captioning_torch_probe"] = sys
    try:
        assert "fpn_mt_image_captioning_torch_probe" not in run.banned_modules()
    finally:
        del sys.modules["fpn_mt_image_captioning_torch_probe"]
    sys.modules["fpn_mt_image_captioning_tpu"] = sys
    try:
        assert "fpn_mt_image_captioning_tpu" in run.banned_modules()
    finally:
        del sys.modules["fpn_mt_image_captioning_tpu"]
