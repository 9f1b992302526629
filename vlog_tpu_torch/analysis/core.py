"""Pass framework for the port's project-invariant static-analysis plane.

The port's runtime planes rest on safety-critical *source-level*
conventions — epoch-fenced claim writes, lock-guarded scheduler state,
non-blocking async handlers, trace capture across thread hops,
registry/docs agreement for every knob/metric/failpoint, and every CUDA
kernel behind its one guarded wrapper. Runtime chaos tests only catch
a violation that fires; this package checks them *statically*:

- every pass is a module with a ``RULE`` name and a
  ``run(modules, pkg_dir) -> list[Finding]`` entry point;
- modules are parsed ONCE (:func:`load_package`) and shared across
  passes — a pass never re-reads source;
- a finding is ``(rule, file, line, message)``; the *baseline file*
  (``vlog_tpu_torch/analysis/BASELINE.txt``) grandfathers explicitly
  justified pre-existing findings, matched on ``(rule, file, message)``
  so line drift from unrelated edits never un-suppresses an entry;
- ``python -m vlog_tpu_torch.analysis`` exits non-zero on any
  non-baselined finding and is wired into tier-1 via
  ``tests/test_torch_analysis.py``.

Passes take an explicit ``pkg_dir`` so the self-tests can aim them at
fixture packages in a tmp dir — the rules are path-relative (``api/``,
``obs/metrics.py``), never hardwired to this repo's checkout location.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path

__all__ = [
    "Finding", "Module", "load_package", "load_baseline", "render_baseline",
    "dotted_name",
]


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    file: str          # posix path relative to the repo root
    line: int
    message: str

    @property
    def key(self) -> tuple[str, str, str]:
        """Baseline identity: line numbers drift with unrelated edits,
        so suppression matches on (rule, file, message) only. Messages
        therefore must not embed line/column numbers."""
        return (self.rule, self.file, self.message)

    def render(self) -> str:
        return f"{self.file}:{self.line}: [{self.rule}] {self.message}"


class Module:
    """One parsed source file, shared by every pass."""

    def __init__(self, path: Path, rel: str, source: str):
        self.path = path
        self.rel = rel               # e.g. "vlog_tpu_torch/api/worker_api.py"
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)

    @property
    def pkg_parts(self) -> tuple[str, ...]:
        """Path components below the scanned package dir (the rule-
        scoping coordinate: ("api", "worker_api.py") etc.)."""
        return Path(self.rel).parts[1:]

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return f"<Module {self.rel}>"


def load_package(pkg_dir: Path) -> list[Module]:
    """Parse every ``*.py`` under ``pkg_dir`` (sorted, pycache skipped).

    ``rel`` paths are relative to the package's PARENT (the repo root),
    so findings print clickable repo-relative locations. A file that
    does not parse is skipped here — the interpreter/test run reports
    syntax errors louder than a linter could.
    """
    pkg_dir = Path(pkg_dir).resolve()
    root = pkg_dir.parent
    mods: list[Module] = []
    for p in sorted(pkg_dir.rglob("*.py")):
        if "__pycache__" in p.parts:
            continue
        source = p.read_text()
        try:
            mods.append(Module(p, p.relative_to(root).as_posix(), source))
        except SyntaxError:
            continue
    return mods


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None (calls,
    subscripts and other dynamic receivers don't resolve statically)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# --------------------------------------------------------------------------
# Baseline: grandfathered findings, committed with justifications
# --------------------------------------------------------------------------

_SEP = " | "


def entry_line(key: tuple[str, str, str]) -> str:
    """Serialize one suppression key — the single source of the
    baseline line format (load/render/splice all go through here or
    :func:`parse_entry`)."""
    return _SEP.join(key)


def parse_entry(line: str) -> tuple[str, str, str] | None:
    """Inverse of :func:`entry_line`; None for blanks/comments/noise."""
    s = line.strip()
    if not s or s.startswith("#"):
        return None
    parts = s.split(_SEP, 2)
    if len(parts) != 3:
        return None
    return (parts[0].strip(), parts[1].strip(), parts[2])


def load_baseline(path: Path) -> set[tuple[str, str, str]]:
    """Parse the baseline file into suppression keys.

    Format: one finding per line ``rule | file | message``; blank lines
    and ``#`` comment lines (the per-entry justifications) are ignored.
    A missing file is an empty baseline.
    """
    try:
        text = Path(path).read_text()
    except OSError:
        return set()
    return {key for key in map(parse_entry, text.splitlines())
            if key is not None}


def render_baseline(findings: list[Finding]) -> str:
    """Serialize current findings as a fresh baseline file body.

    ``--baseline-update`` writes this; justification comments are then
    added by hand above each entry (an unjustified baseline entry is a
    review smell, not a tool feature).
    """
    lines = [
        "# Static-analysis baseline (vlog_tpu_torch/analysis).",
        "# One grandfathered finding per line: rule | file | message.",
        "# Every entry needs a justification comment above it; new code",
        "# must fix its findings, not extend this file.",
        "",
    ]
    # dedupe on the suppression KEY: the same message firing at two
    # lines is one baseline entry, not two identical lines
    lines.extend(entry_line(key) for key in sorted({f.key for f in findings}))
    return "\n".join(lines) + "\n"
