"""Shared compute-thread supervision: timeout envelope + stall watchdog (a copy of
``vlog_tpu/worker/watchdog.py``).

WorkerDaemon (local) and RemoteWorker (HTTP) run blocking compute in a
thread and cancel it cooperatively through the progress callback. This
mixin is that shared machinery, so the two workers cannot drift:

- the overall timeout envelope (``timeout_s`` per job, from
  config.transcode_timeout_s);
- the stall watchdog — compute whose ``done`` counter has not advanced
  within ``stall_window_s`` is cancelled even while its progress WRITES
  keep renewing the lease (a wedged device dispatch re-reporting the
  same batch looks alive to the lease but does no work). The window
  opens when compute starts, NOT at claim time: setup phases before the
  compute thread exists (remote source download, probe) must not count
  as a stall;
- the cooperative-cancel grace period, after which an unresponsive
  thread is abandoned (it can no longer write to the job — its claim is
  released/failed by the caller).

Host classes provide the fields: ``_cancel`` (threading.Event),
``_cancel_reason``, ``cancel_grace_s``, ``stall_window_s``,
``watchdog_tick_s``, and call ``_reset_watchdog()`` per job and
``_note_progress(done)`` from the compute thread's progress callback.
"""

from __future__ import annotations

import asyncio
import logging
import time

log = logging.getLogger("vlog_tpu_torch.worker")


class JobCancelled(Exception):
    """Raised inside the compute thread to abort at the next batch boundary."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class ComputeWatchdogMixin:
    """Timeout + stall supervision over a compute thread (see module doc)."""

    def _reset_watchdog(self) -> None:
        self._progress_marker = time.monotonic()
        self._progress_done = -1

    def _note_progress(self, done: int) -> None:
        """Feed the stall watchdog from the compute thread's progress
        callback. Only FORWARD movement counts — a loop re-reporting the
        same batch is still stalled."""
        if done > self._progress_done:
            self._progress_done = done
            self._progress_marker = time.monotonic()

    async def _run_with_timeout(self, fn, timeout_s: float, what: str):
        """Run blocking compute in a thread; cancel cooperatively on
        timeout or stall. The loop wakes every ``watchdog_tick_s`` to
        check both windows."""
        task = asyncio.create_task(asyncio.to_thread(fn),
                                   name="vlog-watchdog-compute")
        # the stall window opens NOW: pre-compute setup (download/probe)
        # already happened, and the thread owes its first batch within
        # stall_window_s
        self._progress_marker = time.monotonic()
        deadline = time.monotonic() + timeout_s
        while True:
            now = time.monotonic()
            if now >= deadline:
                return await self._cancel_and_drain(
                    task, f"{what} timed out after {timeout_s:.0f}s")
            if (self.stall_window_s > 0
                    and now - self._progress_marker > self.stall_window_s):
                return await self._cancel_and_drain(
                    task, f"stalled: {what} made no progress for "
                          f"{self.stall_window_s:.0f}s")
            try:
                return await asyncio.wait_for(
                    asyncio.shield(task),
                    min(self.watchdog_tick_s, deadline - now))
            except asyncio.TimeoutError:
                continue

    async def _cancel_and_drain(self, task, reason: str):
        """Cooperative cancel: flag the thread, give it the grace window.

        If the thread does not honor the cancel within ``cancel_grace_s``
        (wedged outside any progress callback — e.g. a pathological
        parse), it is abandoned: the caller raises and moves on; the
        zombie thread can no longer write to the job."""
        self._cancel_reason = reason
        self._cancel.set()
        try:
            return await asyncio.wait_for(asyncio.shield(task),
                                          self.cancel_grace_s)
        except asyncio.TimeoutError:
            log.error("%s: compute ignored cancellation for %.0fs; "
                      "abandoning the thread", reason, self.cancel_grace_s)
            raise JobCancelled(f"{reason} (thread unresponsive)") from None
