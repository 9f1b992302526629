"""Cross-job window queue for the continuous-batching ASR engine.

A copy of ``vlog_tpu/asr/queue.py`` (host-side, numpy).

Transcription jobs cut their audio into 30 s windows, VAD-gate them, and
submit the live ones here as :class:`WorkItem`\\ s tagged (job, window
index, start time). The engine drains the queue in ticks, packing windows
from many concurrent jobs into one fixed-shape batch.

Two properties the engine relies on:

* **Batch-key grouping.** ``generate_batch`` builds ONE shared prompt per
  batch and treats (max_new, beam) as static jit arguments, so only
  windows that agree on :class:`BatchKey` (language, task, max_new, beam)
  may ever share a forward. The queue keeps one sub-queue per key.
* **Round-robin fairness.** :meth:`WindowQueue.take` pops at most one
  window per job per pass and rotates the serving order between takes, so
  a 3-hour video (hundreds of queued windows) cannot starve a 30-second
  clip that arrives mid-stream — the clip's windows ride in the very next
  batch.

Thread-safety: submitting jobs run on worker compute threads while the
engine tick thread drains; everything is serialized on one condition.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np


class BatchKey(NamedTuple):
    """Decode parameters a batch must agree on (one shared prompt + the
    static jit arguments of ``generate_batch``)."""

    language: str
    task: str
    max_new: int | None
    beam: int


@dataclass
class WorkItem:
    """One 30 s window awaiting decode."""

    job: str                 # submitting job's key (queue fairness unit)
    index: int               # window index within the job's track
    start_s: float           # window start time in the track
    samples: np.ndarray      # 16 kHz mono float PCM (<= one window)
    enqueued_at: float = field(default_factory=time.monotonic)


class QueueClosed(RuntimeError):
    """Submit after engine shutdown."""


class QueueCancelled(RuntimeError):
    """A blocked submit was aborted by the job's cancel event."""


class WindowQueue:
    """Bounded, batch-key-grouped, job-fair window queue."""

    def __init__(self, max_items: int = 256):
        self.max_items = max_items
        self._cond = threading.Condition()        # lock-order: 22
        # One FIFO per (batch key, job); job order per key is the
        # round-robin rotation. Counts are derived, kept inline so the
        # backpressure check is O(1).
        self._by_key: dict[BatchKey, dict[str, deque[WorkItem]]] = {}  # guarded-by: _cond
        self._order: dict[BatchKey, list[str]] = {}  # guarded-by: _cond
        self._count = 0                              # guarded-by: _cond
        self._closed = False                         # guarded-by: _cond

    def put(self, key: BatchKey, item: WorkItem, *,
            cancel: threading.Event | None = None,
            timeout: float | None = None) -> None:
        """Enqueue one window; blocks while the queue is at capacity
        (backpressure toward the submitting job). ``cancel`` aborts a
        blocked wait with :class:`QueueCancelled`."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                if self._closed:
                    raise QueueClosed("ASR window queue is closed")
                if cancel is not None and cancel.is_set():
                    raise QueueCancelled(f"submit cancelled for {item.job}")
                if self._count < self.max_items:
                    break
                wait = 0.1
                if deadline is not None:
                    wait = min(wait, deadline - time.monotonic())
                    if wait <= 0:
                        raise QueueCancelled(
                            f"submit timed out for {item.job} "
                            f"({self._count} windows queued)")
                self._cond.wait(wait)
            jobs = self._by_key.setdefault(key, {})
            if item.job not in jobs:
                jobs[item.job] = deque()
                self._order.setdefault(key, []).append(item.job)
            jobs[item.job].append(item)
            self._count += 1
            self._cond.notify_all()

    def pick_key(self) -> BatchKey | None:
        """The batch key whose oldest queued window has waited longest —
        ties the tick to the most-starved parameter group."""
        with self._cond:
            best: BatchKey | None = None
            best_t = float("inf")
            for key, jobs in self._by_key.items():
                for dq in jobs.values():
                    if dq and dq[0].enqueued_at < best_t:
                        best_t = dq[0].enqueued_at
                        best = key
            return best

    def take(self, key: BatchKey, max_n: int) -> list[WorkItem]:
        """Pop up to ``max_n`` windows for ``key``, one per job per pass
        (round-robin), rotating the serving order so no job is always
        first. Freed batch rows backfill naturally: every tick's take
        starts from whatever is queued now."""
        with self._cond:
            jobs = self._by_key.get(key)
            order = self._order.get(key)
            if not jobs or not order:
                return []
            taken: list[WorkItem] = []
            progressed = True
            while len(taken) < max_n and progressed:
                progressed = False
                for j in list(order):
                    dq = jobs.get(j)
                    if not dq:
                        continue
                    taken.append(dq.popleft())
                    progressed = True
                    if not dq:
                        del jobs[j]
                        order.remove(j)
                    if len(taken) >= max_n:
                        break
            if taken:
                self._count -= len(taken)
                last = taken[-1].job
                if last in order:   # rotate: next take starts after `last`
                    i = order.index(last)
                    self._order[key] = order[i + 1:] + order[:i + 1]
                if not jobs:
                    self._by_key.pop(key, None)
                    self._order.pop(key, None)
                self._cond.notify_all()
            return taken

    def cancel_job(self, job: str) -> int:
        """Drop every queued window of ``job``; returns how many."""
        with self._cond:
            dropped = 0
            for key in list(self._by_key):
                jobs = self._by_key[key]
                dq = jobs.pop(job, None)
                if dq is not None:
                    dropped += len(dq)
                    order = self._order.get(key, [])
                    if job in order:
                        order.remove(job)
                if not jobs:
                    self._by_key.pop(key, None)
                    self._order.pop(key, None)
            if dropped:
                self._count -= dropped
                self._cond.notify_all()
            return dropped

    def pending(self) -> int:
        with self._cond:
            return self._count

    def wait_for_work(self, timeout: float | None = None) -> bool:
        """Block until at least one window is queued (or timeout/close);
        returns whether work is available."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not (self._count > 0 or self._closed):
                wait = None
                if deadline is not None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        return False
                self._cond.wait(wait)
            return self._count > 0

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
