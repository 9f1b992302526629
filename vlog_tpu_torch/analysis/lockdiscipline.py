"""lockdiscipline: ``# guarded-by:`` fields only touched under their lock.

The scheduler/brownout/delivery state machines are mutated from worker
event loops, per-job compute threads, health-server threads and cache
fill threads at once; their correctness arguments (work-conserving
grants, exactly-once demand withdrawal, quarantine renegotiation) all
assume certain fields are only observed under one lock. The runtime
chaos tests can only catch a torn interleaving that actually fires;
this pass checks the discipline at the source level.

Contract: a field initialized in ``__init__`` may carry a trailing
``# guarded-by: <lock>`` comment (or the comment may sit on its own
line directly above the assignment). Every OTHER load/store of an
attribute with that name *in the same module* must then be:

- lexically inside a ``with`` statement whose context expression's
  dotted path ends in the lock's attribute name (``self._cond``,
  ``self._sched._cond``, bare ``_cond`` all guard ``_cond`` fields —
  helper objects reach their owner's lock through an attribute chain);
- or inside a function whose name ends with ``_locked`` (the
  caller-holds-the-lock convention the scheduler already uses);
- or inside ``__init__`` (the object is not yet shared).

Deferred-code soundness: a ``def``/``lambda`` nested under a ``with
lock:`` block (or under a ``*_locked``/``__init__`` frame) gets NO
credit from the enclosing scope — its body runs later, on whatever
thread calls it, when the lock has long been released. Both the held-
lock set and the caller-holds exemptions therefore reset at every
function boundary (innermost frame only). The cost is a rare false
positive on a lambda invoked synchronously under the lock — accepted:
for a safety gate, a spurious finding beats a silent escape hatch.

Annotations are module-scoped on purpose: matching bare attribute
names across the whole package would flood unrelated classes that
happen to reuse a field name.
"""

from __future__ import annotations

import ast
import re

from vlog_tpu_torch.analysis.core import Finding, Module, dotted_name

RULE = "lockdiscipline"

_ANN_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)\s*$")
# `self.x = ...`, `self.x: T = ...`, and the first line of a wrapped
# `self.x: Very[Long, Type]\n    = ...` all declare field x
_FIELD_RE = re.compile(r"^\s*self\.([A-Za-z_]\w*)\s*(?::|=(?!=))")


def parse_annotations(mod: Module) -> tuple[dict[str, str], list[Finding]]:
    """``{field: lock}`` from the module's guarded-by comments, plus
    findings for malformed annotations (dangling comment with no
    adjacent ``self.x = ...`` assignment, or one field annotated with
    two different locks)."""
    fields: dict[str, str] = {}
    findings: list[Finding] = []
    for i, line in enumerate(mod.lines):
        ann = _ANN_RE.search(line)
        if ann is None:
            continue
        lock = ann.group(1)
        target = _FIELD_RE.match(line)
        if target is None and line.lstrip().startswith("#"):
            # comment-above form: annotation on its own line, the
            # assignment on the next non-comment, non-blank line
            for nxt in mod.lines[i + 1:i + 3]:
                if not nxt.strip() or nxt.lstrip().startswith("#"):
                    continue
                target = _FIELD_RE.match(nxt)
                break
        if target is None:
            findings.append(Finding(
                RULE, mod.rel, i + 1,
                f"dangling guarded-by: {lock} annotation (no adjacent "
                f"'self.<field> = ...' assignment)"))
            continue
        field = target.group(1)
        if fields.get(field, lock) != lock:
            findings.append(Finding(
                RULE, mod.rel, i + 1,
                f"field {field} annotated guarded-by both "
                f"{fields[field]} and {lock}"))
            continue
        fields[field] = lock
    return fields, findings


class _Visitor(ast.NodeVisitor):
    def __init__(self, mod: Module, fields: dict[str, str]):
        self.mod = mod
        self.fields = fields
        self.findings: list[Finding] = []
        self._funcs: list[str] = []
        self._locks: list[str] = []          # dotted names of held locks
        # lock count at the innermost function boundary: a nested
        # def/lambda BODY runs later, when the enclosing `with lock:`
        # has long exited — held locks must not flow into it
        self._lock_floor: list[int] = [0]

    # -- scope tracking ----------------------------------------------------
    def _func(self, node) -> None:
        name = getattr(node, "name", "<lambda>")
        self._funcs.append(name)
        self._lock_floor.append(len(self._locks))
        self.generic_visit(node)
        self._lock_floor.pop()
        self._funcs.pop()

    visit_FunctionDef = _func
    visit_AsyncFunctionDef = _func
    visit_Lambda = _func

    def _with(self, node) -> None:
        held = []
        for item in node.items:
            dotted = dotted_name(item.context_expr)
            if dotted is not None:
                held.append(dotted)
        self._locks.extend(held)
        self.generic_visit(node)
        del self._locks[len(self._locks) - len(held):]

    visit_With = _with
    visit_AsyncWith = _with

    # -- the check ---------------------------------------------------------
    def _allowed(self, lock: str) -> bool:
        # the caller-holds exemptions apply to the INNERMOST function
        # only: a closure defined inside __init__ or a *_locked method
        # runs on whatever thread calls it later, lock-free
        if self._funcs and (self._funcs[-1] == "__init__"
                            or self._funcs[-1].endswith("_locked")):
            return True
        held = self._locks[self._lock_floor[-1]:]
        return any(d == lock or d.endswith("." + lock) for d in held)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        lock = self.fields.get(node.attr)
        if lock is not None and not self._allowed(lock):
            where = self._funcs[-1] if self._funcs else "<module>"
            self.findings.append(Finding(
                RULE, self.mod.rel, node.lineno,
                f"field {node.attr} (guarded-by: {lock}) accessed outside "
                f"'with {lock}' in {where}"))
        self.generic_visit(node)


def run(modules: list[Module], pkg_dir) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        if "guarded-by:" not in mod.source:
            continue
        fields, bad = parse_annotations(mod)
        findings.extend(bad)
        if fields:
            v = _Visitor(mod, fields)
            v.visit(mod.tree)
            findings.extend(v.findings)
    return findings
