"""The check that a run never loads JAX or the JAX package: top-level
names compared whole."""

import ast
import sys
from pathlib import Path

import pytest

from benchmark import harness

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name,bad", [
    ("vlog_tpu", True), ("vlog_tpu.asr.model", True), ("jax", True),
    ("jax.numpy", True), ("jaxlib.xla_client", True), ("flax.linen", True),
    ("vlog_tpu_torch", False), ("vlog_tpu_torch.asr", False),
    ("jaxtyping", False), ("flaxen", False)])
def test_top_level_names_compare_whole(monkeypatch, name, bad):
    for k in [m for m in sys.modules
              if m.split(".")[0] in harness.FORBIDDEN_MODULES]:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, name, object())
    assert (name in harness.forbidden_loaded()) is bad
    if bad:
        with pytest.raises(harness.IsolationError):
            harness.check_isolation("test")
    else:
        harness.check_isolation("test")


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & set(harness.FORBIDDEN_MODULES), path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert "vlog_tpu_torch" not in _imports(path), path
