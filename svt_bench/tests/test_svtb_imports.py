"""No module of the benchmark imports JAX or the JAX package; the reference
imports nothing of the program. Top-level names are compared whole, so the
port (``spec_viterbi_tpu_torch``) is not taken for the JAX package."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

from svt_bench.harness import FORBIDDEN

HERE = Path(__file__).resolve().parent.parent
MODULES = sorted(p for p in HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("name", ["reference.py", "counts.py", "generate.py", "trace.py",
                                  "structures/msv_profile.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    allowed = set(sys.stdlib_module_names) | {"numpy", "torch", "svt_bench"}
    assert top_level_imports(HERE / name) <= allowed


def test_whole_names():
    found = top_level_imports(HERE / "entries" / "decode_auto.py")
    assert "spec_viterbi_tpu_torch" in found and not found & set(FORBIDDEN)
