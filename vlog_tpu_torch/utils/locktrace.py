"""Runtime lock witness: the dynamic half of the port's concurrency plane
(port of ``vlog_tpu/utils/locktrace.py``).

The static side (``analysis/lockorder`` + ``analysis/holdblock``)
proves the *lexical* nestings respect the canonical ``# lock-order:``
ranks; this module proves the *dynamic* ones do. Once :func:`install`
has run (the ``lock_witness`` fixture of the port's concurrency tests on
the CPU; ``chip_smoke.py``'s runtime and daemon phases on the card),
every annotated instance lock of ``vlog_tpu_torch`` constructed from
then on is a :class:`SanitizedLock` / :class:`SanitizedCondition`
witness instead of a raw primitive:

- each thread keeps its held-lock stack; acquiring a lock whose rank
  is <= any held rank records a structured *order violation* report
  carrying both acquisition stacks (the offending acquire and where
  the conflicting lock was taken);
- a blocked ``acquire`` degrades to a bounded probe loop
  (``VLOG_LOCK_PROBE_INTERVAL_S``) that walks the waits-for graph
  (me -> lock -> owner thread -> lock it waits on -> ...); a walk
  that arrives back at the acquiring thread is a REAL deadlock — the
  witness records a report with every participant's live stack and
  raises :class:`DeadlockError` in the detecting thread, so a test
  fails loudly instead of hanging;
- every acquisition feeds the runtime registry's
  ``vlog_lock_wait_seconds`` / ``vlog_lock_hold_seconds`` histograms,
  labeled by the static lock name (``<module>:<field>``).

Installation monkeypatches each annotated module's ``threading``
attribute with a proxy whose ``Lock()``/``RLock()``/``Condition()``
constructors look up the *call site* (file, line) in the table
extracted by ``analysis.lockorder.build_table`` — exactly the
annotated inits construct witnesses; every other lock in the module
stays a raw primitive. Module-LEVEL locks are created at import time,
before :func:`install` can run, and are deliberately out of scope
(they guard module init, never nest with instance locks).

Reports are appended to a process-global list (:func:`reports`); the
callers that install the witness fail on any report. Violations REPORT rather
than raise (a wrong-order acquisition usually still completes — the
report is the signal); only a confirmed waits-for cycle raises,
because there is no completing otherwise.
"""

from __future__ import annotations

import importlib
import os
import sys
import threading
import time
import traceback
from dataclasses import dataclass, field

__all__ = [
    "DeadlockError", "SanitizedCondition", "SanitizedLock", "install",
    "installed", "reports", "reset_reports", "stats", "uninstall",
]

_PROBE_S = float(os.environ.get("VLOG_LOCK_PROBE_INTERVAL_S", "0.05"))
_PROBE_HOPS = 64         # waits-for walk bound (paranoia; cycles are short)


class DeadlockError(RuntimeError):
    """A waits-for cycle was confirmed while blocked on acquire."""


@dataclass
class Report:
    """One witness observation (order violation or deadlock)."""

    kind: str                      # "order" | "deadlock"
    message: str
    locks: tuple[str, ...]         # static lock names involved
    thread: str                    # detecting thread's name
    stacks: dict[str, str] = field(default_factory=dict)

    def render(self) -> str:
        out = [f"[{self.kind}] {self.message} (thread {self.thread})"]
        for who, stack in self.stacks.items():
            out.append(f"--- stack: {who} ---")
            out.append(stack.rstrip())
        return "\n".join(out)


_reports_lock = threading.Lock()
_REPORTS: list[Report] = []

_tls = threading.local()          # .held: list[SanitizedLock] per thread
_BUILT = [0]                      # witnesses constructed (see stats())

# waits-for graph: thread ident -> the SanitizedLock it is blocked on
_waiting_lock = threading.Lock()
_WAITING: dict[int, "SanitizedLock"] = {}


def reports() -> list[Report]:
    with _reports_lock:
        return list(_REPORTS)


def reset_reports() -> list[Report]:
    """Drain and return accumulated reports (tests that deliberately
    provoke violations consume them here so the witness gate stays
    clean)."""
    with _reports_lock:
        out = list(_REPORTS)
        _REPORTS.clear()
        return out


def stats() -> dict:
    """Witnesses constructed, acquisitions (the hold histogram's sample
    count: each acquire observes it once, at its matching release) and
    reports, over the process so far; a caller takes differences around
    a phase."""
    acquisitions = 0.0
    try:
        from vlog_tpu_torch.obs.metrics import runtime

        for fam in runtime().lock_hold_seconds.collect():
            acquisitions += sum(s.value for s in fam.samples
                                if s.name.endswith("_count"))
    except Exception:  # pragma: no cover — metrics are optional here
        pass
    with _reports_lock:
        n_reports = len(_REPORTS)
    return {"built": _BUILT[0], "acquisitions": int(acquisitions),
            "reports": n_reports}


def _record(report: Report) -> None:
    with _reports_lock:
        _REPORTS.append(report)


def _held() -> list["SanitizedLock"]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _frames(frame, limit: int = 16) -> list[tuple[str, int, str]]:
    """(file, line, function) of ``frame`` and its callers, oldest first:
    what ``traceback.format_stack(frame, limit)`` prints, captured
    without reading or parsing any source line. Every acquisition takes
    this snapshot, and formatting it (linecache, caret anchors) costs
    ~10x more: that cost is paid only when a report needs the stack.
    The acquisition's own Python work holds the GIL, and on the card
    it steals that time from the launch-bound threads."""
    out = []
    while frame is not None and len(out) < limit:
        out.append((frame.f_code.co_filename, frame.f_lineno,
                    frame.f_code.co_name))
        frame = frame.f_back
    out.reverse()
    return out


def _observe(histogram_name: str, lock_name: str, seconds: float) -> None:
    try:
        from vlog_tpu_torch.obs.metrics import runtime

        getattr(runtime(), histogram_name).labels(lock_name).observe(seconds)
    except Exception:  # pragma: no cover — metrics must never take a
        pass           # lock path down


class SanitizedLock:
    """Order- and deadlock-checked drop-in for ``threading.Lock`` (or
    ``RLock`` with ``reentrant=True``): the ``acquire``/``release``/
    ``locked``/``_is_owned``/context-manager surface ``Condition``
    needs."""

    def __init__(self, name: str, rank: int | None, *,
                 reentrant: bool = False):
        self.name = name
        self.rank = rank
        self.reentrant = reentrant
        _BUILT[0] += 1
        self._lock = threading.RLock() if reentrant else threading.Lock()
        self._owner: int | None = None
        self._depth = 0
        self._acquired_at = 0.0
        self._acq_frames: list[tuple[str, int, str]] = []

    # -- order + deadlock checks -------------------------------------------
    def _check_order(self) -> None:
        if self.rank is None:
            return
        for held in _held():
            if held is self or held.rank is None:
                continue
            if held.rank >= self.rank:
                _record(Report(
                    kind="order",
                    message=(f"acquiring {self.name} (rank {self.rank}) "
                             f"while holding {held.name} (rank "
                             f"{held.rank})"),
                    locks=(held.name, self.name),
                    thread=threading.current_thread().name,
                    stacks={
                        f"acquire {self.name}":
                            "".join(traceback.format_stack(limit=16)),
                        f"holder of {held.name}": held._acq_stack(),
                    }))

    def _deadlock_cycle(self, me: int) -> list[int] | None:
        """Walk me -> blocked-on lock -> owner -> ... ; a path back to
        ``me`` is a cycle (returns the thread idents on it)."""
        path = [me]
        lock: SanitizedLock | None = self
        for _ in range(_PROBE_HOPS):
            owner = lock._owner
            if owner is None:
                return None        # lock freed mid-walk: no deadlock
            if owner == me:
                return path
            path.append(owner)
            with _waiting_lock:
                lock = _WAITING.get(owner)
            if lock is None:
                return None        # owner is running: it will release
        return None

    def _raise_deadlock(self, me: int, cycle: list[int]) -> None:
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        stacks = {}
        for tid in cycle:
            who = names.get(tid, f"tid={tid}")
            frame = frames.get(tid)
            stacks[who] = ("".join(traceback.format_stack(frame, limit=16))
                           if frame is not None else "<thread gone>")
        participants = ", ".join(names.get(t, str(t)) for t in cycle)
        report = Report(
            kind="deadlock",
            message=(f"waits-for cycle while acquiring {self.name} "
                     f"(threads: {participants})"),
            locks=(self.name,),
            thread=threading.current_thread().name,
            stacks=stacks)
        _record(report)
        raise DeadlockError(report.message)

    # -- lock protocol ------------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        if self.reentrant and self._owner == me:
            self._lock.acquire()
            self._depth += 1
            return True
        self._check_order()
        if not blocking:
            got = self._lock.acquire(False)
            if got:
                self._acquired_locked(me)
            return got
        t0 = time.monotonic()
        deadline = None if timeout is None or timeout < 0 \
            else t0 + timeout
        got = self._lock.acquire(True, _PROBE_S)
        while not got:
            if deadline is not None and time.monotonic() >= deadline:
                return False
            with _waiting_lock:
                _WAITING[me] = self
            try:
                cycle = self._deadlock_cycle(me)
                if cycle is not None:
                    self._raise_deadlock(me, cycle)
                wait = _PROBE_S if deadline is None else \
                    max(0.0, min(_PROBE_S, deadline - time.monotonic()))
                got = self._lock.acquire(True, wait)
            finally:
                with _waiting_lock:
                    _WAITING.pop(me, None)
        _observe("lock_wait_seconds", self.name, time.monotonic() - t0)
        self._acquired_locked(me)
        return True

    def _acquired_locked(self, me: int) -> None:
        self._owner = me
        self._depth = 1
        self._acq_frames = _frames(sys._getframe())
        self._acquired_at = time.monotonic()
        _held().append(self)

    def _acq_stack(self) -> str:
        """Where this lock was last acquired, formatted as
        ``traceback.format_stack`` formats it."""
        return "".join(traceback.StackSummary.from_list(
            [(f, n, name, None) for f, n, name in self._acq_frames]).format())

    def release(self) -> None:
        me = threading.get_ident()
        if self.reentrant and self._owner == me and self._depth > 1:
            self._depth -= 1
            self._lock.release()
            return
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        _observe("lock_hold_seconds", self.name,
                 time.monotonic() - self._acquired_at)
        self._owner = None
        self._depth = 0
        self._lock.release()

    def locked(self) -> bool:
        return self._owner is not None

    def _is_owned(self) -> bool:
        # Condition's ownership probe (it duck-types this)
        return self._owner == threading.get_ident()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        return (f"<SanitizedLock {self.name} rank={self.rank} "
                f"owner={self._owner}>")


def SanitizedCondition(name: str, rank: int | None) -> threading.Condition:
    """A ``threading.Condition`` over a sanitized (reentrant) lock:
    ``wait()`` releases through :meth:`SanitizedLock.release` (closing
    the hold-time sample and popping the held stack) and re-acquires
    through :meth:`SanitizedLock.acquire` (re-checking the order), so
    a condition wait is indistinguishable from release+acquire — which
    is exactly its semantics."""
    return threading.Condition(SanitizedLock(name, rank, reentrant=True))


# --------------------------------------------------------------------------
# Installation: monkeypatch the annotated modules' lock constructors
# --------------------------------------------------------------------------

class _ThreadingProxy:
    """Stands in for an annotated module's ``threading`` global: lock
    constructors called FROM an annotated init line build witnesses;
    everything else (Thread, Event, local, unannotated locks) passes
    through to the real module."""

    def __init__(self, table: dict[tuple[str, int], tuple[str, int | None]]):
        self._table = table

    def _lookup(self) -> tuple[str, int | None] | None:
        frame = sys._getframe(2)
        return self._table.get(
            (os.path.normpath(frame.f_code.co_filename), frame.f_lineno))

    def Lock(self):
        hit = self._lookup()
        if hit is None:
            return threading.Lock()
        return SanitizedLock(hit[0], hit[1])

    def RLock(self):
        hit = self._lookup()
        if hit is None:
            return threading.RLock()
        return SanitizedLock(hit[0], hit[1], reentrant=True)

    def Condition(self, lock=None):
        hit = self._lookup()
        if hit is None or lock is not None:
            return threading.Condition(lock)
        return SanitizedCondition(hit[0], hit[1])

    def __getattr__(self, attr):
        return getattr(threading, attr)


_installed: dict[str, object] = {}      # module name -> original attr


def installed() -> bool:
    return bool(_installed)


def install(pkg_dir=None) -> list[str]:
    """Arm the witness: parse the package's lock annotations and patch
    every module that has any. Returns the patched module names.
    Idempotent; :func:`uninstall` reverses it."""
    if _installed:
        return sorted(_installed)
    from vlog_tpu_torch.analysis import default_pkg_dir, load_package
    from vlog_tpu_torch.analysis.lockorder import build_table

    pkg_dir = pkg_dir or default_pkg_dir()
    modules = load_package(pkg_dir)
    table, _ = build_table(modules)
    by_mod: dict[str, dict[tuple[str, int], tuple[str, int | None]]] = {}
    for mod in modules:
        locks = table.get(mod.rel)
        if not locks:
            continue
        sites = {
            (os.path.normpath(str(mod.path)), info.line):
                (info.name, info.rank)
            for info in locks.values()}
        dotted = mod.rel[:-3].replace("/", ".")
        by_mod[dotted] = sites
    for name, sites in by_mod.items():
        module = importlib.import_module(name)
        _installed[name] = module.__dict__.get("threading")
        module.threading = _ThreadingProxy(sites)       # type: ignore
    return sorted(_installed)


def uninstall() -> None:
    for name, original in _installed.items():
        module = sys.modules.get(name)
        if module is not None:
            module.threading = original                 # type: ignore
    _installed.clear()
