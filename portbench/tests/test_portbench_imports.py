"""No module of the benchmark imports JAX or the JAX package, with
top-level names compared whole, and the plain reference imports nothing
but the standard library."""

import ast
import sys
from pathlib import Path

from portbench import run

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "hotstuff_tpu"}


def imported(path: Path) -> set[str]:
    """Top-level names of every module `path` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not imported(f) & FORBIDDEN, f


def test_the_reference_imports_the_standard_library_alone():
    names = imported(PKG / "reference.py") - {"__future__"}
    assert names <= set(sys.stdlib_module_names), names
    assert "hotstuff_tpu_torch" not in names


def test_the_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "hotstuff_tpu_torch_fake", object())
    assert "hotstuff_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hotstuff_tpu.crypto", object())
    assert run.forbidden_modules() == ["hotstuff_tpu.crypto"]
