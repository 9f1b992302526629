"""epochfence: claim-gated Worker-API writes must reach the epoch fence.

The zombie-incarnation fence only holds if EVERY claim-gated route
that mutates job/video state validates ``X-Claim-Epoch``: one unfenced
endpoint re-opens the hole where a swept-then-reclaimed job's previous
incarnation (same worker name!) corrupts the successor attempt's
tree/trace. The chaos test proves the six existing routes 409 a stale
epoch; this pass proves a NEW route cannot ship without the fence.

Rule, applied to ``api/worker_api.py``: every route registered with a
write method (``add_post``/``add_put``/``add_patch``/``add_delete``)
whose path binds a ``{job_id`` or ``{video_id`` parameter is a
claim-gated write. Its handler must — directly or through module-local
helpers (bounded transitive closure) — reference one of:

- ``guard_epoch``   (jobs.state: the server-side fence itself),
- ``_claim_epoch``  (header parse passed into the claims layer, which
  fences inside its transaction),
- ``_active_claim_row`` (the upload path's fenced claim lookup).

Read routes (``add_get``) and parameterless routes (claim, heartbeat,
register — they create or refresh the claim rather than write under
one) are out of scope by construction.
"""

from __future__ import annotations

import ast

from vlog_tpu_torch.analysis.core import Finding, Module

RULE = "epochfence"

FENCE_NAMES = frozenset({"guard_epoch", "_claim_epoch", "_active_claim_row"})
_WRITE_ADDERS = {"add_post": "POST", "add_put": "PUT",
                 "add_patch": "PATCH", "add_delete": "DELETE"}
_GATED_PARAMS = ("{job_id", "{video_id")


def _referenced_names(fn: ast.AST) -> set[str]:
    names: set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
    return names


def _closure(handler: str, refs: dict[str, set[str]],
             depth: int = 3) -> set[str]:
    """Names reachable from ``handler`` through module-local functions
    (depth-bounded: the fence always sits in the handler or one helper
    down — unbounded closure would hide a genuinely missing fence
    behind an accidental reference chain)."""
    seen: set[str] = set()
    frontier = {handler}
    out: set[str] = set()
    for _ in range(depth):
        nxt: set[str] = set()
        for name in frontier:
            if name in seen or name not in refs:
                continue
            seen.add(name)
            out |= refs[name]
            nxt |= refs[name] & refs.keys()
        frontier = nxt - seen
        if not frontier:
            break
    return out


def check_module(mod: Module) -> list[Finding]:
    refs: dict[str, set[str]] = {}
    for node in mod.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            refs[node.name] = _referenced_names(node)
    findings: list[Finding] = []
    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _WRITE_ADDERS
                and len(node.args) >= 2):
            continue
        path_node, handler_node = node.args[0], node.args[1]
        if not (isinstance(path_node, ast.Constant)
                and isinstance(path_node.value, str)):
            continue
        path = path_node.value
        if not any(p in path for p in _GATED_PARAMS):
            continue
        handler = handler_node.id if isinstance(handler_node, ast.Name) \
            else None
        method = _WRITE_ADDERS[node.func.attr]
        if handler is None or handler not in refs:
            findings.append(Finding(
                RULE, mod.rel, node.lineno,
                f"claim-gated route {method} {path} registers a handler "
                f"this pass cannot resolve to a module-level function"))
            continue
        if not (_closure(handler, refs) & FENCE_NAMES):
            findings.append(Finding(
                RULE, mod.rel, node.lineno,
                f"claim-gated route {method} {path} (handler {handler}) "
                f"never reaches guard_epoch/_claim_epoch/_active_claim_row "
                f"— a stale-epoch zombie could write through it"))
    return findings


def run(modules: list[Module], pkg_dir) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        parts = mod.pkg_parts
        if parts[-1] == "worker_api.py" and "api" in parts[:-1]:
            findings.extend(check_module(mod))
    return findings
