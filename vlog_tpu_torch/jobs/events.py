"""Realtime dispatch/event plane: pub/sub wakeups for claims and SSE (a
copy of ``vlog_tpu/jobs/events.py``).

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
- :class:`PgNotifyBus` — the same API bridged over Postgres
  LISTEN/NOTIFY on the first-party libpq client (db/pg.py), so
  multi-node fleets get cross-process wakeups through the database
  they already share, with no extra broker to run (the reference needs
  a Redis; we need nothing).

Every consumer treats a wakeup as advisory: the claim/poll logic that
runs afterwards is unchanged, so a lost notification degrades to the
old poll latency instead of losing work.
"""

from __future__ import annotations

import asyncio
import json
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


class PgNotifyBus(LocalEventBus):
    """LocalEventBus fronted by Postgres LISTEN/NOTIFY.

    publish() issues ``pg_notify`` through the shared PgDatabase (so
    every node's listener hears it); a dedicated libpq connection in a
    daemon thread LISTENs and feeds the in-process bus. Payloads ride
    as JSON in the notify payload (8000-byte PG limit — wakeup hints
    are tiny)."""

    CHANNELS = (CH_JOBS, CH_PROGRESS, CH_WEBHOOKS)

    def __init__(self, db: Any) -> None:
        super().__init__()
        self._db = db
        self._listener = None          # db/pg.py PgListener
        self._started = False
        # strong refs: ensure_future alone leaves the task weakly
        # referenced and collectable mid-flight — a GC'd notify task
        # silently drops the wakeup
        self._notify_tasks: set[Any] = set()

    async def start(self) -> None:
        await super().start()
        if self._started:
            return
        self._started = True
        from vlog_tpu_torch.db.pg import PgListener

        def deliver(channel: str, payload: str) -> None:
            try:
                data = json.loads(payload) if payload else {}
            except ValueError:
                data = {"raw": payload}
            # LocalEventBus.publish marshals into the loop
            LocalEventBus.publish(self, channel, data)

        self._listener = PgListener(self._db.url, self.CHANNELS, deliver)
        await asyncio.to_thread(self._listener.start)

    def publish(self, channel: str, payload: dict | None = None) -> None:
        """NOTIFY through the database; local delivery happens when the
        listener connection hears it back (single code path for local
        and remote subscribers)."""
        body = json.dumps(payload or {}, separators=(",", ":"))

        async def _notify() -> None:
            try:
                await self._db.execute(
                    "SELECT pg_notify(:ch, :body)",
                    {"ch": channel, "body": body})
            except Exception:           # noqa: BLE001 — wakeups are hints
                log.debug("pg_notify failed", exc_info=True)

        try:
            asyncio.get_running_loop()
            task = asyncio.ensure_future(_notify())
            self._notify_tasks.add(task)
            task.add_done_callback(self._notify_tasks.discard)
        except RuntimeError:
            loop = self._loop
            if loop is not None and not loop.is_closed():
                asyncio.run_coroutine_threadsafe(_notify(), loop)
            # else: no loop to send from; poll covers it

    async def close(self) -> None:
        if self._listener is not None:
            await asyncio.to_thread(self._listener.stop)
            self._listener = None
        self._started = False
        await super().close()


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
    """The event bus matching a Database instance: NOTIFY-backed on the
    Postgres facade, in-process otherwise. Cached on the db object so
    every service sharing the Database shares the bus."""
    bus = getattr(db, "_event_bus", None)
    if bus is None:
        if getattr(db, "dialect", "sqlite") == "postgres":
            bus = PgNotifyBus(db)
        else:
            bus = LocalEventBus()
        db._event_bus = bus
    return bus
