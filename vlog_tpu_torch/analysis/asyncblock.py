"""asyncblock: no blocking calls inside ``async def`` in serving code.

The API processes (public, admin, worker API) and the delivery plane
are single-event-loop servers: one synchronous ``open()`` on a slow
volume or one ``time.sleep`` stalls EVERY in-flight request — playback
segments, claim polls, heartbeats. The convention since the delivery
plane is that anything touching disk/processes hops through
``asyncio.to_thread`` (which this pass does not flag: a blocking name
*passed* to ``to_thread`` is a reference, not a call).

Flagged inside the nearest-enclosing ``async def`` (a ``lambda`` or
nested ``def`` re-scopes — its body runs wherever it is called, usually
a worker thread):

- ``time.sleep`` (asyncio code must ``await asyncio.sleep``);
- the ``open()`` builtin (sync file I/O);
- bulk byte I/O methods (``read_bytes``/``read_text``/``write_bytes``/
  ``write_text`` — Path and file objects alike: payload size is
  unbounded, so the stall is too);
- ``subprocess.*`` / ``os.system`` / ``os.popen`` (process spawn +
  wait);
- the sync DB facade internals (``Database._run_execute`` and
  siblings) — handlers must stay on the awaitable facade, which
  offloads to the connection thread.

Deliberate boundary: pure-metadata syscalls (``stat``/``exists``/
``mkdir``/``rename``/``unlink``/``resolve``) are NOT flagged — they
are single dentry operations whose worst case is the volume itself
hanging, and flagging them would bury the bulk-I/O signal under dozens
of microsecond-scale findings (the hot upload paths offload even these
by hand). If a plane grows a metadata call on a network filesystem's
critical path, offload it anyway; the lint is a floor, not the
ceiling.

Scope: modules under ``api/``, ``delivery/``, ``web/``, ``worker/``
(since the preemption-tolerant drain plane), and — since the fleet-scale
coordination plane — ``jobs/``. Worker processes are event-loop servers
too: the same loop runs lease heartbeats, the drain supervisor, the
incremental-checkpoint uploader, and the health server's readiness
answers, so a blocking call there stalls exactly the writes that keep a
draining job from being swept (compute is fine — it runs on threads via
``_run_with_timeout``, outside any ``async def``). ``jobs/`` is in scope
for the same reason: claim transactions, the lease sweeper, and the
event-bus publish paths all run on the serving loops, and a blocking
call inside one stalls every parked long-poll claimant at once.
"""

from __future__ import annotations

import ast

from vlog_tpu_torch.analysis.core import Finding, Module, dotted_name

RULE = "asyncblock"

SCOPED_DIRS = frozenset({"api", "delivery", "web", "worker", "jobs"})

# fully-dotted blocking calls (module attribute form)
_BLOCKING_DOTTED = {
    "time.sleep": "time.sleep()",
    "os.system": "os.system()",
    "os.popen": "os.popen()",
}
# any call on these module receivers blocks (run/call/Popen/check_output…)
_BLOCKING_RECEIVERS = {"subprocess"}
# bulk byte I/O on any receiver (Path, file object): unbounded payload
# means unbounded event-loop stall
_BULK_IO_METHODS = frozenset({
    "read_bytes", "read_text", "write_bytes", "write_text",
})
# sync internals of the DB facade (db/core.py): the awaitable methods
# wrap these in the connection executor — calling one directly from a
# handler runs SQL on the event loop.
_SYNC_DB_METHODS = frozenset({
    "_run_execute", "_run_execute_many", "_run_fetch_one", "_run_fetch_all",
})
# bare-name origins (``from time import sleep``)
_BLOCKING_ORIGINS = {"time.sleep": "time.sleep()"}


def _import_origins(tree: ast.AST) -> dict[str, str]:
    """Map local bare names to dotted origins (``from time import
    sleep as zz`` -> {"zz": "time.sleep"})."""
    origins: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                origins[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    return origins


class _Visitor(ast.NodeVisitor):
    def __init__(self, mod: Module):
        self.mod = mod
        self.findings: list[Finding] = []
        self._origins = _import_origins(mod.tree)
        self._stack: list[ast.AST] = []      # function/lambda nesting

    # -- function scope tracking ------------------------------------------
    def _scoped(self, node: ast.AST) -> None:
        self._stack.append(node)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _scoped
    visit_AsyncFunctionDef = _scoped
    visit_Lambda = _scoped

    def _async_scope(self) -> str | None:
        """Name of the nearest enclosing function IF it is async."""
        if self._stack and isinstance(self._stack[-1], ast.AsyncFunctionDef):
            return self._stack[-1].name
        return None

    # -- call classification ----------------------------------------------
    def _classify(self, call: ast.Call) -> str | None:
        func = call.func
        if isinstance(func, ast.Name):
            if func.id == "open":
                return "open()"
            origin = self._origins.get(func.id)
            if origin in _BLOCKING_ORIGINS:
                return _BLOCKING_ORIGINS[origin]
            return None
        if isinstance(func, ast.Attribute):
            if func.attr in _SYNC_DB_METHODS:
                return f"sync DB facade .{func.attr}()"
            if func.attr in _BULK_IO_METHODS:
                return f"bulk I/O .{func.attr}()"
            dotted = dotted_name(func)
            if dotted is None:
                return None
            if dotted in _BLOCKING_DOTTED:
                return _BLOCKING_DOTTED[dotted]
            head = dotted.split(".", 1)[0]
            resolved = self._origins.get(head, head).split(".", 1)[0]
            if resolved in _BLOCKING_RECEIVERS:
                return f"{dotted}()"
        return None

    def visit_Call(self, node: ast.Call) -> None:
        fn = self._async_scope()
        if fn is not None:
            what = self._classify(node)
            if what is not None:
                self.findings.append(Finding(
                    RULE, self.mod.rel, node.lineno,
                    f"blocking {what} inside async def {fn} "
                    f"(offload via asyncio.to_thread)"))
        self.generic_visit(node)


def run(modules: list[Module], pkg_dir) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        if not (set(mod.pkg_parts[:-1]) & SCOPED_DIRS):
            continue
        v = _Visitor(mod)
        v.visit(mod.tree)
        findings.extend(v.findings)
    return findings
