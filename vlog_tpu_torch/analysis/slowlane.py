"""slowlane: compile-heavy tests stay out of the fast lane.

The tier-1 lane (``pytest -m 'not slow'``) has a hard wall-clock
budget on a 1-core CI VM; ROADMAP.md's standing rule is that tests
driving the codec/ASR *compile paths* ride the ``slow`` marker. This
pass enforces that rule instead of relying on review: a ``test_*``
function that references a compile-path trigger —

- a ``ladder_encode*`` program builder,
- a ``hevc_chain*`` program builder,
- ``AsrEngine`` / ``get_engine`` (a forward through either compiles the
  Whisper graph for that batch shape)

— without a ``slow`` marker is a finding. The marker is recognized
anywhere in the decorator AST (``@pytest.mark.slow``, and
``pytest.param(..., marks=pytest.mark.slow)`` inside a parametrize —
the per-param idiom test_raw_speed.py uses) and via a module-level
``pytestmark`` containing ``slow``.

Escapes, for tests that touch a trigger but are genuinely cheap (tiny
checkpoints, interpret-mode shims):

- ``# slowlane-ok: <why>`` trailing on the triggering line or on the
  ``def`` line exempts that occurrence / function;
- ``# slowlane-ok(module): <why>`` anywhere in the file exempts the
  whole module.

Like every escape comment in this package, the reason is part of the
contract: it documents why the fast lane can afford the call.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from vlog_tpu_torch.analysis.core import Finding, Module, load_package

RULE = "slowlane"

_TRIGGER_PREFIXES = ("ladder_encode", "hevc_chain")
_TRIGGER_EXACT = frozenset({"AsrEngine", "get_engine"})

_OK_RE = re.compile(r"#\s*slowlane-ok\b")
_OK_MODULE_RE = re.compile(r"#\s*slowlane-ok\(module\)")


def _is_trigger(name: str) -> bool:
    return name in _TRIGGER_EXACT or name.startswith(_TRIGGER_PREFIXES)


def _has_slow_mark(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> bool:
    """``slow`` attribute anywhere in the decorator AST: plain
    ``@pytest.mark.slow`` and parametrize per-param marks alike."""
    for dec in fn.decorator_list:
        for node in ast.walk(dec):
            if isinstance(node, ast.Attribute) and node.attr == "slow":
                return True
    return False


def _module_slow(mod: Module) -> bool:
    """Module-level ``pytestmark = pytest.mark.slow`` (or a list
    containing it)."""
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "pytestmark"
                for t in node.targets):
            for n in ast.walk(node.value):
                if isinstance(n, ast.Attribute) and n.attr == "slow":
                    return True
    return False


def _line_ok(mod: Module, lineno: int) -> bool:
    if 1 <= lineno <= len(mod.lines):
        return bool(_OK_RE.search(mod.lines[lineno - 1]))
    return False


def _test_functions(mod: Module):
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name.startswith("test_"):
            yield node


def _trigger_refs(fn: ast.AST):
    """(lineno, name) for every trigger *reference* in the function —
    Name loads and attribute accesses. Definition names and string
    literals (textwrap'd source, parametrize ids) never match."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and _is_trigger(node.id):
            yield node.lineno, node.id
        elif isinstance(node, ast.Attribute) and _is_trigger(node.attr):
            yield node.lineno, node.attr


def _scan_module(mod: Module) -> list[Finding]:
    if _module_slow(mod):
        return []
    if any(_OK_MODULE_RE.search(line) for line in mod.lines):
        return []
    findings: list[Finding] = []
    for fn in _test_functions(mod):
        if _has_slow_mark(fn) or _line_ok(mod, fn.lineno):
            continue
        seen: set[str] = set()
        for lineno, name in _trigger_refs(fn):
            if name in seen or _line_ok(mod, lineno):
                continue
            seen.add(name)
            findings.append(Finding(
                RULE, mod.rel, lineno,
                f"{fn.name} calls compile path {name} without a 'slow' "
                f"marker — compile-heavy tests stay out of the tier-1 "
                f"fast lane (mark slow or annotate '# slowlane-ok:')"))
    return findings


def run(modules: list[Module], pkg_dir) -> list[Finding]:
    # This pass audits the TEST tree, not the package: triggers in
    # vlog_tpu_torch/ itself are production call sites, not lane violations.
    tests_dir = Path(pkg_dir).resolve().parent / "tests"
    if not tests_dir.is_dir():
        return []
    findings: list[Finding] = []
    for mod in load_package(tests_dir):
        findings.extend(_scan_module(mod))
    return findings
