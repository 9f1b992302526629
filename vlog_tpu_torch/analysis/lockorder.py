"""lockorder: a canonical partial order over every annotated lock.

``lockdiscipline`` proves guarded fields are only touched under their
lock; it says nothing about the ORDER locks are taken in. With ~30
locks across the scheduler, engine, executor, drain, brownout and
delivery planes, a single call path that nests two of them the wrong
way round deadlocks the fleet — and review can't see a cross-module
nesting. This pass makes the order a machine-checked invariant:

- every ``self.<field> = threading.Lock/RLock/Condition()`` init may
  carry a ``# lock-order: <rank>`` comment (trailing, or on its own
  line directly above — same placement grammar as ``guarded-by``).
  Ranks are small ints, globally unique, and define the canonical
  acquisition order: a thread may only acquire a lock whose rank is
  STRICTLY GREATER than every lock it already holds.
- the pass walks every function and collects the lock-acquisition
  graph from lexically nested ``with <lock>:`` scopes. A ``with``
  expression resolves to a lock by its last dotted component (the
  same suffix rule lockdiscipline uses: ``self._cond``,
  ``self._sched._cond`` and bare ``_cond`` all name a ``_cond``
  field) — preferring a lock field in the same module, else a unique
  package-wide match.
- an edge that acquires rank <= a held rank is a *rank inversion*
  finding; any cycle in the graph (possible among ranked and
  rank-less guarded-by locks alike) is a *cycle* finding.

Agreement lint (the annotations must stay coherent or the runtime
witness in ``utils/locktrace.py`` — which builds its table from the
same comments — silently loses coverage):

- inside a lockdiscipline-annotated module (one carrying any
  ``guarded-by:``), EVERY lock field init must carry a rank;
- every ``guarded-by: <lock>`` must name a lock field initialized in
  the module;
- a dangling ``lock-order`` comment (no adjacent lock init), one
  field ranked twice, or the same rank used by two different locks
  are each findings.

Module-level locks (created at import time, e.g. engine/scheduler
singleton guards) are exempt: they serialize module init, are never
nested with instance locks, and the runtime witness cannot intercept
them anyway (they exist before it installs).

Deferred-body soundness mirrors lockdiscipline: a ``def``/``lambda``
nested under a ``with lock:`` runs later, lock-free, so held locks
never flow across a function boundary (innermost frame only).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass

from vlog_tpu_torch.analysis import lockdiscipline
from vlog_tpu_torch.analysis.core import Finding, Module, dotted_name

RULE = "lockorder"

_RANK_RE = re.compile(r"#\s*lock-order:\s*(\d+)\s*$")
# `self._cond = threading.Condition()` / `self._lock: Lock = threading.Lock()`
_LOCK_INIT_RE = re.compile(
    r"^\s*self\.([A-Za-z_]\w*)\s*(?::[^=]+)?=\s*"
    r"threading\.(Lock|RLock|Condition)\(")


@dataclass(frozen=True)
class LockInfo:
    """One annotated instance-lock field (the unit both static passes
    and the runtime witness reason about)."""

    rel: str           # module path relative to the repo root
    field: str         # attribute name on the owning object
    kind: str          # Lock | RLock | Condition
    line: int          # 1-based init line
    rank: int | None   # lock-order rank; None = guarded-by-only lock

    @property
    def name(self) -> str:
        return f"{self.rel}:{self.field}"


def parse_locks(mod: Module) -> tuple[dict[str, LockInfo], list[Finding]]:
    """``{field: LockInfo}`` for the module's instance-lock inits, plus
    findings for malformed rank annotations (dangling comment, one
    field ranked twice)."""
    inits: dict[str, tuple[str, int]] = {}      # field -> (kind, line)
    for i, line in enumerate(mod.lines):
        m = _LOCK_INIT_RE.match(line)
        if m is not None:
            inits.setdefault(m.group(1), (m.group(2), i + 1))

    ranks: dict[str, int] = {}
    findings: list[Finding] = []
    for i, line in enumerate(mod.lines):
        ann = _RANK_RE.search(line)
        if ann is None:
            continue
        rank = int(ann.group(1))
        target = _LOCK_INIT_RE.match(line)
        if target is None and line.lstrip().startswith("#"):
            # comment-above form: the init on the next non-comment,
            # non-blank line (same grammar as guarded-by)
            for nxt in mod.lines[i + 1:i + 3]:
                if not nxt.strip() or nxt.lstrip().startswith("#"):
                    continue
                target = _LOCK_INIT_RE.match(nxt)
                break
        if target is None:
            findings.append(Finding(
                RULE, mod.rel, i + 1,
                f"dangling lock-order: {rank} annotation (no adjacent "
                f"'self.<field> = threading.Lock/RLock/Condition()' init)"))
            continue
        field = target.group(1)
        if ranks.get(field, rank) != rank:
            findings.append(Finding(
                RULE, mod.rel, i + 1,
                f"lock field {field} ranked both lock-order: "
                f"{ranks[field]} and {rank}"))
            continue
        ranks[field] = rank

    locks = {field: LockInfo(mod.rel, field, kind, line, ranks.get(field))
             for field, (kind, line) in inits.items()}
    return locks, findings


def build_table(modules: list[Module]
                ) -> tuple[dict[str, dict[str, LockInfo]], list[Finding]]:
    """Package lock table ``{rel: {field: LockInfo}}`` + the agreement-
    lint findings (missing rank in an annotated module, guarded-by
    naming no lock, duplicate rank across the package)."""
    table: dict[str, dict[str, LockInfo]] = {}
    findings: list[Finding] = []
    by_rank: dict[int, LockInfo] = {}
    for mod in modules:
        locks, bad = parse_locks(mod)
        findings.extend(bad)
        annotated = "guarded-by:" in mod.source
        if annotated:
            fields, _ = lockdiscipline.parse_annotations(mod)
            for field, info in locks.items():
                if info.rank is None:
                    findings.append(Finding(
                        RULE, mod.rel, info.line,
                        f"lock field {field} has no '# lock-order:' rank "
                        f"(module is lockdiscipline-annotated)"))
            for field, lock in fields.items():
                if lock not in locks:
                    findings.append(Finding(
                        RULE, mod.rel, 1,
                        f"guarded-by: {lock} (on field {field}) names no "
                        f"threading lock field initialized in this module"))
            # guarded-by-only locks join the graph rank-less: cycle
            # detection still covers them
            tracked = {f: info for f, info in locks.items()
                       if info.rank is not None or f in fields.values()}
        else:
            tracked = {f: info for f, info in locks.items()
                       if info.rank is not None}
        for info in tracked.values():
            if info.rank is None:
                continue
            other = by_rank.get(info.rank)
            if other is not None:
                findings.append(Finding(
                    RULE, mod.rel, info.line,
                    f"duplicate lock-order rank {info.rank}: "
                    f"{other.name} and {info.name}"))
            else:
                by_rank[info.rank] = info
        if tracked:
            table[mod.rel] = tracked
    return table, findings


def resolve(table: dict[str, dict[str, LockInfo]], rel: str,
            dotted: str) -> LockInfo | None:
    """A ``with`` expression's lock, by its last dotted component:
    same-module field first, else a unique package-wide match."""
    field = dotted.rsplit(".", 1)[-1]
    info = table.get(rel, {}).get(field)
    if info is not None:
        return info
    hits = [locks[field] for locks in table.values() if field in locks]
    return hits[0] if len(hits) == 1 else None


@dataclass(frozen=True)
class Edge:
    held: LockInfo
    acquired: LockInfo
    rel: str
    line: int
    func: str


class _Visitor(ast.NodeVisitor):
    """Collect acquisition edges from lexically nested ``with`` scopes
    (innermost-frame semantics — see module docstring)."""

    def __init__(self, mod: Module, table: dict[str, dict[str, LockInfo]]):
        self.mod = mod
        self.table = table
        self.edges: list[Edge] = []
        self._funcs: list[str] = []
        self._held: list[LockInfo] = []
        self._floor: list[int] = [0]

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
        entered: list[LockInfo] = []
        for item in node.items:
            dotted = dotted_name(item.context_expr)
            if dotted is None:
                continue
            info = resolve(self.table, self.mod.rel, dotted)
            if info is None:
                continue
            func = self._funcs[-1] if self._funcs else "<module>"
            for held in self._held[self._floor[-1]:]:
                if held.name != info.name:
                    self.edges.append(Edge(held, info, self.mod.rel,
                                           node.lineno, func))
            entered.append(info)
            self._held.append(info)
        self.generic_visit(node)
        del self._held[len(self._held) - len(entered):]

    visit_With = _with
    visit_AsyncWith = _with


def _cycle_findings(edges: list[Edge]) -> list[Finding]:
    """One finding per acquisition cycle: edge a->b closes a cycle iff
    a is reachable back from b. Each cycle (as a node set) is reported
    once, at the lexically first edge that closes it."""
    graph: dict[str, set[str]] = {}
    where: dict[tuple[str, str], Edge] = {}
    for e in sorted(edges, key=lambda e: (e.rel, e.line)):
        graph.setdefault(e.held.name, set()).add(e.acquired.name)
        graph.setdefault(e.acquired.name, set())
        where.setdefault((e.held.name, e.acquired.name), e)

    def path(src: str, dst: str) -> list[str] | None:
        prev: dict[str, str | None] = {src: None}
        queue = [src]
        while queue:
            node = queue.pop(0)
            if node == dst:
                out: list[str] = []
                cur: str | None = node
                while cur is not None:
                    out.append(cur)
                    cur = prev[cur]
                return out[::-1]
            for nxt in sorted(graph[node]):
                if nxt not in prev:
                    prev[nxt] = node
                    queue.append(nxt)
        return None

    findings: list[Finding] = []
    seen: set[frozenset[str]] = set()
    for (a, b), e in sorted(where.items(),
                            key=lambda kv: (kv[1].rel, kv[1].line)):
        back = path(b, a)
        if back is None:
            continue
        cycle = frozenset(back)
        if cycle in seen:
            continue
        seen.add(cycle)
        findings.append(Finding(
            RULE, e.rel, e.line,
            "lock-acquisition cycle: " + " -> ".join(back + [b])))
    return findings


def run(modules: list[Module], pkg_dir) -> list[Finding]:
    table, findings = build_table(modules)
    if not table:
        return findings
    edges: list[Edge] = []
    for mod in modules:
        v = _Visitor(mod, table)
        v.visit(mod.tree)
        edges.extend(v.edges)
    for e in edges:
        if e.held.rank is not None and e.acquired.rank is not None \
                and e.acquired.rank <= e.held.rank:
            findings.append(Finding(
                RULE, e.rel, e.line,
                f"rank inversion: acquiring {e.acquired.name} (rank "
                f"{e.acquired.rank}) while holding {e.held.name} (rank "
                f"{e.held.rank}) in {e.func}"))
    findings.extend(_cycle_findings(edges))
    return findings
