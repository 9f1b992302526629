"""holdblock: no blocking operations inside a ``with <lock>`` body.

A held lock turns one slow call into fleet-wide convoy: every thread
that needs the lock — scheduler grants, engine ticks, delivery fills —
parks behind the sleeper. The discipline the concurrent planes already
follow by hand (snapshot under the lock, do I/O outside; see the
DiskL2 and heartbeat-coalescer comments) becomes machine-checked here.

Scope: the bodies of ``with`` statements whose context expression
resolves to an annotated lock (``lock-order`` ranked or a
``guarded-by`` target — the table ``lockorder.build_table`` extracts).
Innermost-frame semantics as everywhere in this plane: a nested
``def``/``lambda`` body runs later, lock-free, and gets a fresh empty
held set.

Flagged while a lock is held:

- ``time.sleep`` (and ``from time import sleep`` aliases);
- the ``open()`` builtin, bulk I/O (``read_bytes``/``read_text``/
  ``write_bytes``/``write_text``) and file/socket stream methods
  (``.read``/``.write``/``.flush``/``.recv``/``.send``/``.sendall``/
  ``.connect``/``.accept``);
- ``subprocess.*`` / ``os.system`` / ``os.popen``;
- ``.result()`` (Future joins) and ``.join()`` on thread-like
  receivers;
- the DB facade (``execute``/``execute_many``/``fetch_*``/``commit``
  and the sync ``_run_*`` internals);
- ``.wait()``/``.wait_for()`` on anything OTHER than the condition
  being held: waiting on the condition you hold is the one blocking
  call a lock exists for (the wait releases it); parking on a
  different condition or an Event keeps the held lock held.

Escape hatch: a trailing ``# holds-ok: <reason>`` suppresses the
finding on that line — and an EMPTY reason is itself a finding. The
escape is for genuine serialization requirements (e.g. the RC
journal's canonical append order), not convenience.
"""

from __future__ import annotations

import ast
import re

from vlog_tpu_torch.analysis import lockorder
from vlog_tpu_torch.analysis.core import Finding, Module, dotted_name

RULE = "holdblock"

_OK_RE = re.compile(r"#\s*holds-ok:\s*(.*?)\s*$")

_BLOCKING_DOTTED = {
    "time.sleep": "time.sleep()",
    "os.system": "os.system()",
    "os.popen": "os.popen()",
}
_BLOCKING_RECEIVERS = {"subprocess"}
_BLOCKING_ORIGINS = {"time.sleep": "time.sleep()"}
_BULK_IO_METHODS = frozenset({
    "read_bytes", "read_text", "write_bytes", "write_text",
})
_STREAM_METHODS = frozenset({
    "read", "write", "flush", "recv", "send", "sendall", "connect",
    "accept",
})
_DB_METHODS = frozenset({
    "execute", "execute_many", "executemany", "fetch_one", "fetch_all",
    "fetch_val", "commit", "_run_execute", "_run_execute_many",
    "_run_fetch_one", "_run_fetch_all",
})


class _Visitor(ast.NodeVisitor):
    def __init__(self, mod: Module,
                 table: dict[str, dict[str, lockorder.LockInfo]]):
        self.mod = mod
        self.table = table
        self.findings: list[Finding] = []
        self._origins: dict[str, str] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    self._origins[alias.asname or alias.name] = \
                        f"{node.module}.{alias.name}"
        self._funcs: list[str] = []
        self._held: list[lockorder.LockInfo] = []
        self._floor: list[int] = [0]

    # -- scope tracking ----------------------------------------------------
    def _func(self, node) -> None:
        self._funcs.append(getattr(node, "name", "<lambda>"))
        self._floor.append(len(self._held))
        self.generic_visit(node)
        self._floor.pop()
        self._funcs.pop()

    visit_FunctionDef = _func
    visit_AsyncFunctionDef = _func
    visit_Lambda = _func

    def _with(self, node) -> None:
        entered = 0
        for item in node.items:
            dotted = dotted_name(item.context_expr)
            if dotted is None:
                continue
            info = lockorder.resolve(self.table, self.mod.rel, dotted)
            if info is not None:
                self._held.append(info)
                entered += 1
        self.generic_visit(node)
        del self._held[len(self._held) - entered:]

    visit_With = _with
    visit_AsyncWith = _with

    # -- classification ----------------------------------------------------
    def _classify(self, call: ast.Call) -> str | None:
        func = call.func
        if isinstance(func, ast.Name):
            if func.id == "open":
                return "open()"
            origin = self._origins.get(func.id)
            if origin in _BLOCKING_ORIGINS:
                return _BLOCKING_ORIGINS[origin]
            return None
        if not isinstance(func, ast.Attribute):
            return None
        attr = func.attr
        if attr in _DB_METHODS:
            return f"DB facade .{attr}()"
        if attr in _BULK_IO_METHODS:
            return f"bulk I/O .{attr}()"
        if attr == "result":
            return ".result() (future join)"
        dotted = dotted_name(func)
        if attr in _STREAM_METHODS:
            # a stream method on a lock-resolved receiver is Condition
            # API misuse, not stream I/O; everything else blocks
            recv = dotted.rsplit(".", 1)[0] if dotted else None
            if recv is None or lockorder.resolve(
                    self.table, self.mod.rel, recv) is None:
                return f"stream I/O .{attr}()"
        if attr == "join" and dotted is not None:
            owner = dotted.split(".")[-2] if "." in dotted else ""
            if "thread" in owner.lower():
                return f".join() on {owner}"
        if dotted is None:
            return None
        if dotted in _BLOCKING_DOTTED:
            return _BLOCKING_DOTTED[dotted]
        head = dotted.split(".", 1)[0]
        resolved = self._origins.get(head, head).split(".", 1)[0]
        if resolved in _BLOCKING_RECEIVERS:
            return f"{dotted}()"
        return None

    def _wait_violation(self, call: ast.Call,
                        held: list[lockorder.LockInfo]) -> str | None:
        """``X.wait()`` / ``X.wait_for()``: allowed only when X IS the
        (sole) held condition — that wait releases the lock; any other
        receiver parks while the held locks stay held."""
        func = call.func
        if not isinstance(func, ast.Attribute) \
                or func.attr not in ("wait", "wait_for"):
            return None
        dotted = dotted_name(func)
        recv = dotted.rsplit(".", 1)[0] if dotted else None
        target = None if recv is None else lockorder.resolve(
            self.table, self.mod.rel, recv)
        others = [h for h in held
                  if target is None or h.name != target.name]
        if target is not None and not others:
            return None
        what = recv or "<dynamic>"
        return (f".{func.attr}() on {what} while holding "
                + ", ".join(sorted({h.name for h in others})))

    def visit_Call(self, node: ast.Call) -> None:
        held = self._held[self._floor[-1]:]
        if held:
            line = self.mod.lines[node.lineno - 1] \
                if node.lineno <= len(self.mod.lines) else ""
            ok = _OK_RE.search(line)
            what = self._wait_violation(node, held)
            if what is None:
                blocked = self._classify(node)
                if blocked is not None:
                    locks = ", ".join(sorted({h.name for h in held}))
                    what = f"blocking {blocked} while holding {locks}"
            if what is not None:
                func = self._funcs[-1] if self._funcs else "<module>"
                if ok is not None:
                    if not ok.group(1):
                        self.findings.append(Finding(
                            RULE, self.mod.rel, node.lineno,
                            f"holds-ok escape without a justification "
                            f"in {func}"))
                else:
                    self.findings.append(Finding(
                        RULE, self.mod.rel, node.lineno,
                        f"{what} in {func}"))
        self.generic_visit(node)


def run(modules: list[Module], pkg_dir) -> list[Finding]:
    table, _ = lockorder.build_table(modules)
    if not table:
        return []
    findings: list[Finding] = []
    for mod in modules:
        v = _Visitor(mod, table)
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
