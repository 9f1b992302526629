"""Realtime dispatch/event plane: pub/sub wakeups for claims and SSE (a
copy of ``vlog_tpu/jobs/events.py`` without its Postgres LISTEN/NOTIFY
bus: the port serves sqlite only).

Reference analog: the reference dispatches work through Redis Streams
with consumer groups (api/job_queue.py:34-350) and fans progress out
over Redis pub/sub channels (api/pubsub.py:9-14), so a worker learns of
a new job in milliseconds instead of a poll interval. This framework's
queue of record is the database (claims.py) — correct but poll-bound.
This module closes the latency gap first-party:

- :class:`LocalEventBus` — an in-process asyncio pub/sub. On sqlite
  deployments every service that shares the process (tests, the
  single-box stack) gets event-driven dispatch; separate processes
  still converge within one poll interval (the DB poll remains the
  source of truth — events are a WAKEUP hint, never a data channel).
- The JAX package's ``PgNotifyBus`` bridges the same API over Postgres
  LISTEN/NOTIFY; the port has no Postgres facade (ROADMAP Queue A item
  13b), so every database gets the in-process bus.

Every consumer treats a wakeup as advisory: the claim/poll logic that
runs afterwards is unchanged, so a lost notification degrades to the
old poll latency instead of losing work.
"""

from __future__ import annotations

import asyncio
import logging
import threading
from collections import defaultdict
from typing import Any

from vlog_tpu_torch.utils import failpoints

log = logging.getLogger("vlog.events")

# Wakeup channels (PG NOTIFY identifiers must be plain identifiers).
CH_JOBS = "vlog_jobs"            # a job became claimable
CH_PROGRESS = "vlog_progress"    # job progress / completion updates
CH_WEBHOOKS = "vlog_webhooks"    # a webhook delivery became claimable


class Subscription:
    """One subscriber's queue on a channel. Bounded: wakeups are hints,
    so dropping a burst loses nothing (the consumer polls anyway)."""

    def __init__(self, bus: "LocalEventBus", channel: str):
        self._bus = bus
        self.channel = channel
        self._q: asyncio.Queue[dict] = asyncio.Queue(maxsize=64)

    def _offer(self, payload: dict) -> None:
        try:
            self._q.put_nowait(payload)
        except asyncio.QueueFull:
            pass                        # consumer is behind; poll covers it

    async def get(self, timeout: float | None = None) -> dict | None:
        """Next event, or None on timeout (the poll-fallback signal)."""
        try:
            if timeout is None:
                return await self._q.get()
            return await asyncio.wait_for(self._q.get(), timeout)
        except (asyncio.TimeoutError, TimeoutError):
            return None

    def drain(self) -> int:
        """Discard queued events (used after a poll already saw them)."""
        n = 0
        while not self._q.empty():
            self._q.get_nowait()
            n += 1
        return n

    async def wait_or(self, stop: asyncio.Event, timeout: float,
                      extra=()) -> None:
        """Sleep until a wakeup, the timeout, ``stop``, or any of the
        ``extra`` awaitables completing — whichever comes first. The
        wake-or-stop idle pattern every consumer loop needs, with the
        cancellation bookkeeping in one place. ``extra`` members (e.g.
        the daemon's in-flight slot job tasks) are only waited on,
        never cancelled or consumed."""
        wake = asyncio.ensure_future(self.get(timeout=timeout))
        stop_t = asyncio.ensure_future(stop.wait())
        try:
            await asyncio.wait({wake, stop_t, *extra},
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            for f in (wake, stop_t):
                if not f.done():
                    f.cancel()
            await asyncio.gather(wake, stop_t, return_exceptions=True)

    def close(self) -> None:
        self._bus._drop(self)


class LocalEventBus:
    """In-process pub/sub. Publish is thread-safe (worker threads and
    libpq listener threads publish into the loop the subscribers run on)."""

    def __init__(self) -> None:
        self._subs: dict[str, list[Subscription]] = defaultdict(list)
        self._loop: asyncio.AbstractEventLoop | None = None
        self._lock = threading.Lock()

    def _adopt_loop(self) -> None:
        try:
            self._loop = asyncio.get_running_loop()
        except RuntimeError:
            pass

    def subscribe(self, channel: str) -> Subscription:
        self._adopt_loop()
        sub = Subscription(self, channel)
        with self._lock:
            self._subs[channel].append(sub)
        return sub

    def _drop(self, sub: Subscription) -> None:
        with self._lock:
            try:
                self._subs[sub.channel].remove(sub)
            except ValueError:
                pass

    def publish(self, channel: str, payload: dict | None = None) -> None:
        """Deliver to all current subscribers. Safe from any thread; a
        call from outside the loop is marshalled with call_soon_threadsafe."""
        payload = payload or {}
        with self._lock:
            subs = list(self._subs.get(channel, ()))
        if not subs:
            return
        loop = self._loop
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is not None:
            for s in subs:
                s._offer(payload)
        elif loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(
                lambda: [s._offer(payload) for s in subs])
        # else: no loop to deliver into; consumers poll

    async def start(self) -> None:
        self._adopt_loop()

    async def close(self) -> None:
        with self._lock:
            self._subs.clear()


def wake(db: Any, channel: str, payload: dict | None = None) -> None:
    """Post-commit wakeup hint. Never load-bearing: a lost hint
    degrades to poll latency, so failures are swallowed — every
    publisher (claims, webhooks) shares this one rule. The
    ``events.publish`` failpoint drops the hint here (the killed-notify
    chaos path: parked claimants must fall back to their jittered
    re-check / poll with zero jobs lost)."""
    try:
        failpoints.hit("events.publish")
        bus_for(db).publish(channel, payload or {})
    except Exception:   # noqa: BLE001
        log.debug("wakeup publish failed", exc_info=True)


def bus_for(db: Any) -> LocalEventBus:
    """The event bus of a Database instance (in-process). Cached on the
    db object so every service sharing the Database shares the bus."""
    bus = getattr(db, "_event_bus", None)
    if bus is None:
        bus = LocalEventBus()
        db._event_bus = bus
    return bus
