"""tracehop: thread hand-offs in traced modules carry the trace context.

``obs/trace.py`` propagates context via contextvars, which compute
threads do NOT inherit: ``asyncio.to_thread`` copies the context (and
is therefore exempt here), but a raw ``threading.Thread(target=...)``
or a thread-pool ``submit`` starts the callee untraced — its spans
silently drop and the job's waterfall grows a hole exactly where the
expensive work happened. The contract since the trace plane is an
explicit ``capture()`` before the hop and ``attach(ctx)`` inside the
callee (trace.py module docstring); WhisperFlow-style streaming
decode will multiply these hops.

Rule: in any module that imports ``vlog_tpu_torch.obs.trace`` (module-level
or inside a function — the worker daemon imports lazily), a function
that constructs ``threading.Thread(target=...)`` or calls ``submit``
on a pool/executor receiver must also reference ``capture`` or
``attach``. Modules that never import the tracer are out of scope —
untraced infrastructure (DB connection threads, codec producers) is
allowed to stay dependency-free.

``submit`` receivers are matched by name (dotted path containing
``pool`` or ``executor``): the pipeline executor's *job-queue*
``submit`` is a batch hand-off inside one traced run, not a context
boundary, and must not be flagged by accident.
"""

from __future__ import annotations

import ast

from vlog_tpu_torch.analysis.core import Finding, Module, dotted_name

RULE = "tracehop"

_TRACE_MODULE = "vlog_tpu_torch.obs.trace"
_CTX_FUNCS = frozenset({"capture", "attach"})
_POOLISH = ("pool", "executor")


def _imports_trace(mod: Module) -> bool:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            if any(a.name == _TRACE_MODULE for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.module == _TRACE_MODULE:
                return True
            if node.module is not None \
                    and f"{node.module}.trace" == _TRACE_MODULE \
                    and any(a.name == "trace" for a in node.names):
                return True
    return False


def _is_thread_hop(call: ast.Call) -> str | None:
    func = call.func
    name = func.attr if isinstance(func, ast.Attribute) else (
        func.id if isinstance(func, ast.Name) else None)
    if name == "Thread" and any(k.arg == "target" for k in call.keywords):
        return "threading.Thread(target=...)"
    if name == "submit" and isinstance(func, ast.Attribute):
        dotted = dotted_name(func.value)
        if dotted is not None and any(p in dotted.lower() for p in _POOLISH):
            return f"{dotted}.submit(...)"
    return None


class _Visitor(ast.NodeVisitor):
    def __init__(self, mod: Module):
        self.mod = mod
        self.findings: list[Finding] = []

    def _func(self, node) -> None:
        hops: list[tuple[int, str]] = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                hop = _is_thread_hop(sub)
                if hop is not None:
                    hops.append((sub.lineno, hop))
        if hops:
            names = {n.id for n in ast.walk(node)
                     if isinstance(n, ast.Name)}
            names |= {a.attr for a in ast.walk(node)
                      if isinstance(a, ast.Attribute)}
            if not (names & _CTX_FUNCS):
                for line, hop in hops:
                    self.findings.append(Finding(
                        RULE, self.mod.rel, line,
                        f"thread hop {hop} in {node.name} without trace "
                        f"capture()/attach() — spans from the callee "
                        f"will drop"))
        # do NOT recurse: hops of nested defs were collected by the walk
        # above against the outer function's references, which is the
        # useful scope (the capture usually happens in the enclosing
        # function and the attach inside the nested target).

    visit_FunctionDef = _func
    visit_AsyncFunctionDef = _func


def run(modules: list[Module], pkg_dir) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        if mod.pkg_parts[0] == "analysis" or not _imports_trace(mod):
            continue
        v = _Visitor(mod)
        for node in mod.tree.body:
            v.visit(node)
        findings.extend(v.findings)
    return findings
