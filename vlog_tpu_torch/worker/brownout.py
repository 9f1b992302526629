"""Coordination-plane brownout breaker for worker claim loops (a copy of
``vlog_tpu/worker/brownout.py``).

The compute breaker (worker/breaker.py) protects the fleet from a sick
WORKER; this one protects the worker from a sick COORDINATION PLANE. A
flapping Postgres (or, for remote workers, an unreachable Worker API)
used to surface as a crash-log per poll and a fixed 1-second sleep —
hundreds of workers hot-spinning reconnect attempts against a database
that is trying to come back up is exactly the thundering herd the
jittered job backoff (PR 1) exists to prevent, one layer down.

Shape: every transient coordination error grows a jittered exponential
delay the claim loop sleeps out; ``VLOG_DB_BREAKER_THRESHOLD``
consecutive errors mark the worker **browned out** — readiness degrades
(worker/health.py ``breaker_check``) so orchestrators stop routing and
operators see the real cause, while the loop keeps probing on backoff
(capped at ``VLOG_DB_BREAKER_COOLDOWN``). The first successful poll
closes the breaker and restores readiness. Ingestion pauses gracefully;
playback keeps serving from the delivery plane's caches
(delivery/plane.py stale-while-unavailable publish state).

Every error increments ``vlog_claim_errors_total{source}`` and the
browned-out state rides the ``vlog_claim_breaker_open`` gauge. Like the
compute breaker this is synchronous and clock-injected so tests drive
it with a fake clock and zero sleeps.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

from vlog_tpu_torch import config

log = logging.getLogger("vlog_tpu_torch.worker.brownout")

__all__ = ["CoordinationBreaker"]


class CoordinationBreaker:
    """Consecutive-transient-error breaker with jittered backoff pacing."""

    def __init__(self, *, source: str = "daemon",
                 threshold: int | None = None,
                 cooldown_s: float | None = None,
                 base_backoff_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        self.source = source
        self.threshold = (config.DB_BREAKER_THRESHOLD if threshold is None
                          else threshold)
        self.cooldown_s = (config.DB_BREAKER_COOLDOWN_S if cooldown_s is None
                           else cooldown_s)
        self.base_backoff_s = base_backoff_s
        self._clock = clock
        # The claim loop mutates this state while the health server's
        # readiness thread (worker/health.py breaker_check) and the
        # stats command read it — every access goes through _lock.
        self._lock = threading.Lock()             # lock-order: 42
        self._consecutive = 0                 # guarded-by: _lock
        self._open = False                    # guarded-by: _lock
        self._opened_at = 0.0                 # guarded-by: _lock
        # lifetime brownouts (stats surface)
        self.opens = 0                        # guarded-by: _lock
        self.last_error: str | None = None    # guarded-by: _lock

    @property
    def is_open(self) -> bool:
        with self._lock:
            return self._open

    @property
    def consecutive_errors(self) -> int:
        with self._lock:
            return self._consecutive

    def record_error(self, exc: BaseException) -> float:
        """Count one transient coordination error; returns the jittered
        delay the claim loop should sleep before probing again."""
        with self._lock:
            self._consecutive += 1
            self.last_error = f"{type(exc).__name__}: {exc}"[:300]
            consecutive = self._consecutive
            opened = False
            if not self._open and self._consecutive >= self.threshold:
                self._open = True
                self._opened_at = self._clock()
                self.opens += 1
                opened = True
            last_error = self.last_error
        self._metrics().claim_errors.labels(self.source).inc()
        if opened:
            self._metrics().claim_breaker_open.set(1)
            log.warning(
                "coordination plane browned out after %d consecutive "
                "errors (%s); claiming paused on backoff, readiness "
                "degraded", consecutive, last_error)
        # One jittered-exponential policy for the whole failure plane
        # (jobs/claims.py). The exponent is clamped: _consecutive grows
        # without bound through a long outage and 2**1075 would overflow
        # float long after the cap had made growth moot anyway.
        from vlog_tpu_torch.jobs.claims import retry_backoff_s

        return retry_backoff_s(min(consecutive, 32),
                               base=self.base_backoff_s,
                               cap=max(self.cooldown_s,
                                       self.base_backoff_s))

    def record_success(self) -> None:
        """A poll reached the coordination plane: close the brownout."""
        with self._lock:
            was_open, self._open = self._open, False
            opened_at = self._opened_at
            self._consecutive = 0
            self.last_error = None
        if was_open:
            log.info("coordination plane recovered after %.1fs brownout",
                     self._clock() - opened_at)
            self._metrics().claim_breaker_open.set(0)

    @staticmethod
    def _metrics():
        from vlog_tpu_torch.obs.metrics import runtime

        return runtime()

    def snapshot(self) -> dict:
        """Stats-command / readiness surface."""
        with self._lock:
            return {"open": self._open,
                    "consecutive_errors": self._consecutive,
                    "opens": self.opens,
                    "last_error": self.last_error}
