"""Worker-side circuit breaker (a copy of
``vlog_tpu/worker/breaker.py``).

Reference parity: api/redis_client.py's circuit-broken singleton — N
consecutive failures open the circuit, a cooldown gates a single
half-open probe, and the probe's outcome decides between closing and
re-opening. Here the protected resource is the worker's own compute
path: a daemon whose backend is sick (driver wedged, device lost, model
dir gone) must stop claiming jobs, or it becomes a fleet-wide poison
pump — claiming work it cannot finish and burning every job's retry
budget.

The breaker is deliberately synchronous and clock-injected: transitions
happen inside ``allow`` / ``record_*`` calls, so tests drive it with a
fake clock and zero sleeps.
"""

from __future__ import annotations

import enum
import logging
import time
from typing import Callable

from vlog_tpu_torch import config

log = logging.getLogger("vlog_tpu_torch.worker.breaker")


class BreakerState(str, enum.Enum):
    CLOSED = "closed"          # healthy: claims flow
    OPEN = "open"              # tripped: no claims until cooldown lapses
    HALF_OPEN = "half_open"    # one probe job in flight; outcome decides


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe."""

    def __init__(self, *, failure_threshold: int | None = None,
                 cooldown_s: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self.failure_threshold = (config.BREAKER_FAILURE_THRESHOLD
                                  if failure_threshold is None
                                  else failure_threshold)
        self.cooldown_s = (config.BREAKER_COOLDOWN_S if cooldown_s is None
                           else cooldown_s)
        self._clock = clock
        self._state = BreakerState.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self.opens = 0            # lifetime trips (stats surface)

    @property
    def state(self) -> BreakerState:
        return self._state

    @property
    def consecutive_failures(self) -> int:
        return self._consecutive_failures

    def allow(self) -> bool:
        """May the caller start a unit of work right now?

        OPEN converts to HALF_OPEN exactly once per cooldown lapse: the
        first caller after the cooldown gets True (the probe) and every
        other caller False until the probe reports back.
        """
        if self._state is BreakerState.CLOSED:
            return True
        if self._state is BreakerState.OPEN:
            if self._clock() - self._opened_at >= self.cooldown_s:
                self._state = BreakerState.HALF_OPEN
                self._observe()
                log.info("breaker half-open: sending probe")
                return True
            return False
        return False      # HALF_OPEN: probe already in flight

    def release_probe(self) -> None:
        """The probe slot was granted but there was nothing to probe with
        (no claimable job, or the claim itself errored before any compute
        ran). Return to OPEN with the cooldown already spent, so the next
        ``allow`` hands out a fresh probe immediately — otherwise the
        breaker would wedge in HALF_OPEN forever waiting for an outcome
        that can never arrive.
        """
        if self._state is BreakerState.HALF_OPEN:
            self._state = BreakerState.OPEN
            self._opened_at = self._clock() - self.cooldown_s
            self._observe()

    def record_success(self) -> None:
        if self._state is not BreakerState.CLOSED:
            log.info("breaker closed: probe succeeded")
            self._state = BreakerState.CLOSED
            self._observe()
        self._consecutive_failures = 0

    def record_failure(self) -> None:
        self._consecutive_failures += 1
        if self._state is BreakerState.HALF_OPEN:
            # failed probe: straight back to OPEN for another cooldown
            self._trip()
        elif (self._state is BreakerState.CLOSED
              and self._consecutive_failures >= self.failure_threshold):
            self._trip()

    def _trip(self) -> None:
        self._state = BreakerState.OPEN
        self._opened_at = self._clock()
        self.opens += 1
        self._observe()
        log.warning(
            "breaker OPEN after %d consecutive failures; pausing claims "
            "for %.0fs", self._consecutive_failures, self.cooldown_s)

    def _observe(self) -> None:
        """Report the transition to the process metrics registry (the
        breaker used to be visible only through the stats command)."""
        from vlog_tpu_torch.obs.metrics import runtime

        runtime().observe_breaker(self._state.value)

    def snapshot(self) -> dict:
        """Stats-command / heartbeat surface."""
        return {"state": self._state.value,
                "consecutive_failures": self._consecutive_failures,
                "opens": self.opens}
