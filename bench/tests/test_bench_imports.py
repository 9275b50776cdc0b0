"""Nothing under bench/ imports JAX or the JAX package, and the reference
imports nothing of the port.  Top-level names are compared whole:
``repro_torch`` begins with ``repro`` and is not it."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from bench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(spec.BENCH.rglob("*.py"))


def top_level_imports(path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    spec.BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.BENCH / "reference").rglob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = top_level_imports(path)
    assert "repro_torch" not in names
    assert names <= {"__future__", "importlib", "math", "torch", "bench"}


def test_names_compared_whole():
    from bench.cell import forbidden_modules
    assert forbidden_modules(["repro_torch", "repro_torch.models",
                              "jaxtyping", "reprolib"]) == []
    assert forbidden_modules(["repro.models", "jax._src", "flax"]) == [
        "flax", "jax", "repro"]


def test_a_run_loads_no_jax():
    """The harness, the port's model and the reference in one process:
    none of the forbidden top-level modules is loaded."""
    code = (
        "import sys; sys.path[:0] = ['src', '.']\n"
        "from bench import cell, check, measure\n"
        "from repro_torch.models.model import Model\n"
        "from repro_torch.launch import partition\n"
        "print(cell.forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
