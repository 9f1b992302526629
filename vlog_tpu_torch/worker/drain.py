"""Grace-budgeted drain state + preemption-notice watcher (a copy of
``vlog_tpu/worker/drain.py``).

Preemptible fleets evict with a short notice, not a crash: the host
gets SIGTERM (or a metadata notice) and a bounded window before the
plug is pulled. Before this plane, SIGTERM cancelled in-flight compute
at the next batch boundary and threw every completed batch of the
attempt away. Now a notice flips the worker into DRAINING:

- the claim loop stops granting (no new work on a dying host);
- in-flight jobs keep running — executors finish already-submitted
  batches and flush rung/segment state (remote workers stream the
  completed, digest-bearing segments up as they land);
- the claim lease is heartbeat-extended so the expired-claim sweep
  cannot hand a draining job away mid-flush;
- at the ``VLOG_DRAIN_GRACE_S`` deadline anything still running is
  force-cancelled with :data:`DRAIN_CANCEL_REASON` and requeued as a
  refunded ``preempted`` failure (enums.FailureClass.PREEMPTED) for a
  successor to resume.

A second SIGTERM during the drain skips the grace window entirely —
``kill -TERM`` twice always means *now*.

:class:`DrainState` is the shared drain flag: mutated by the signal
handler and the admin ``drain`` command on the event loop, read by the
health server thread's readiness probe and by ``stats`` — hence the
lock and the ``guarded-by`` annotations (analysis/lockdiscipline.py
holds every access to them).

:class:`PreemptionWatcher` polls the two notice channels preemptible
platforms actually provide: a file path (``VLOG_PREEMPTION_FILE``,
touched by a node-level agent) and a metadata URL
(``VLOG_PREEMPTION_URL``, HTTP 200 = evicting; polled with ``aiohttp``,
the port's one HTTP client library). The ``preempt.notice``
failpoint makes the next poll an eviction notice, so chaos runs drive
the whole drain → checkpoint → hand-off loop deterministically.
"""

from __future__ import annotations

import logging
import threading
import time
from pathlib import Path

from vlog_tpu_torch import config
from vlog_tpu_torch.utils import failpoints

log = logging.getLogger("vlog_tpu_torch.worker.drain")

# Cancel reason prefix the workers' JobCancelled handlers classify as
# PREEMPTED (refunded requeue) instead of shutdown-release or failure.
DRAIN_CANCEL_REASON = "preempted: drain grace exhausted"


class DrainState:
    """Thread-safe drain flag + grace-deadline bookkeeping."""

    def __init__(self) -> None:
        self._lock = threading.Lock()             # lock-order: 40
        self._active = False          # guarded-by: _lock
        self._reason = ""             # guarded-by: _lock
        self._started_mono = 0.0      # guarded-by: _lock
        self._grace_s = 0.0           # guarded-by: _lock

    def begin(self, reason: str, grace_s: float) -> bool:
        """Enter the draining state; False if already draining (the
        first notice wins — its deadline stands)."""
        with self._lock:
            if self._active:
                return False
            self._active = True
            self._reason = reason
            self._started_mono = time.monotonic()
            self._grace_s = max(0.0, float(grace_s))
            return True

    @property
    def active(self) -> bool:
        with self._lock:
            return self._active

    def grace_left_s(self) -> float:
        with self._lock:
            if not self._active:
                return 0.0
            return max(0.0,
                       self._started_mono + self._grace_s - time.monotonic())

    def expired(self) -> bool:
        """True once the grace window has lapsed (or the
        ``drain.deadline`` failpoint forces it — the chaos hook the
        deadline-enforcement test arms)."""
        with self._lock:
            if not self._active:
                return False
            deadline = self._started_mono + self._grace_s
        try:
            failpoints.hit("drain.deadline")
        except failpoints.FailpointError:
            return True
        return time.monotonic() >= deadline

    def elapsed_s(self) -> float:
        with self._lock:
            if not self._active:
                return 0.0
            return time.monotonic() - self._started_mono

    def snapshot(self) -> dict:
        with self._lock:
            active = self._active
            reason = self._reason
            grace = self._grace_s
            left = (max(0.0, self._started_mono + grace - time.monotonic())
                    if active else 0.0)
        return {"active": active, "reason": reason,
                "grace_s": grace, "grace_left_s": round(left, 3)}


class PreemptionWatcher:
    """Polls the configured notice channels; fires a callback once."""

    def __init__(self, *, file: str | Path | None = None,
                 url: str | None = None, poll_s: float | None = None):
        self.file = Path(file) if file else None
        self.url = url or None
        self.poll_s = (config.PREEMPTION_POLL_S if poll_s is None
                       else float(poll_s))
        self._client = None   # lazy, reused across URL polls

    async def aclose(self) -> None:
        if self._client is not None:
            await self._client.close()
            self._client = None

    @classmethod
    def from_config(cls) -> "PreemptionWatcher | None":
        """A watcher when any notice channel is configured — or when
        the ``preempt.notice`` failpoint is armed, so chaos runs need
        no real file/URL plumbing to trigger an eviction."""
        if (config.PREEMPTION_FILE or config.PREEMPTION_URL
                or failpoints.is_armed("preempt.notice")):
            return cls(file=config.PREEMPTION_FILE or None,
                       url=config.PREEMPTION_URL or None)
        return None

    async def check(self) -> str | None:
        """One poll: the notice reason, or None."""
        try:
            failpoints.hit("preempt.notice")
        except failpoints.FailpointError:
            return "injected preemption notice (preempt.notice failpoint)"
        if self.file is not None and self.file.exists():
            return f"preemption notice file present ({self.file})"
        if self.url:
            import asyncio

            import aiohttp

            try:
                if self._client is None:
                    # one session for the watcher's lifetime — a fresh
                    # pool + TLS context every 2 s poll adds up over a
                    # worker's whole life
                    self._client = aiohttp.ClientSession(
                        timeout=aiohttp.ClientTimeout(total=2.0))
                async with self._client.get(self.url) as r:
                    if r.status == 200:
                        return ("preemption notice URL answered 200 "
                                f"({self.url})")
            except (aiohttp.ClientError, OSError, asyncio.TimeoutError):
                # an unreachable metadata endpoint is the steady state
                # on most hosts; never let it kill the watcher
                log.debug("preemption URL poll failed", exc_info=True)
        return None

    async def watch(self, stop, on_notice) -> None:
        """Poll until a notice fires (``await on_notice(reason)``, then
        return) or ``stop`` (asyncio.Event) is set."""
        import asyncio

        try:
            while not stop.is_set():
                reason = await self.check()
                if reason is not None:
                    log.warning("preemption notice: %s", reason)
                    await on_notice(reason)
                    return
                try:
                    await asyncio.wait_for(stop.wait(), self.poll_s)
                except asyncio.TimeoutError:
                    pass
        finally:
            await self.aclose()
