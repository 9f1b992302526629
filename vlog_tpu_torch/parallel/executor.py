"""Deterministic rate-control feedback (port of
``vlog_tpu/parallel/executor.py::LaggedRateControl``).

The port runs batches serially, but keeps the JAX backend's feedback
schedule so both plan the same QPs: observations are posted per batch
and applied strictly in batch order, up to ``batch_index - depth``
before each dispatch (and up to the last batch while a controller is
hunting).
"""

from __future__ import annotations

from collections import deque


class LaggedRateControl:
    def __init__(self, controllers: dict):
        self._controllers = controllers
        self._pending: dict[str, deque] = {n: deque() for n in controllers}

    def post(self, name: str, batch_index: int, *, nbytes: int,
             frames: int, frame_qps=None, cost: float | None = None) -> None:
        self._pending[name].append(
            (batch_index, nbytes, frames, frame_qps, cost))

    def apply_upto(self, batch_index: int) -> None:
        """Apply observations of batches <= ``batch_index`` in order."""
        for name, dq in self._pending.items():
            ctl = self._controllers[name]
            while dq and dq[0][0] <= batch_index:
                _, nbytes, frames, mix, cost = dq.popleft()
                ctl.observe(nbytes, frames, frame_qps=mix)
                if cost is not None:
                    ctl.calibrate_proxy(nbytes, cost)

    def hunting(self) -> bool:
        """True while any controller wants the tight (depth-0) loop."""
        return any(c.hunting for c in self._controllers.values())

    def replay(self, entries: dict[int, dict], start_batch: int,
               depth: int) -> None:
        """Rebuild controller state from a rate-control journal
        (backends/rc_journal.py) as if batches ``0..start_batch-1`` had
        run live: the same apply lag and hunting drains as the dispatch
        loop. Afterwards, planning the resumed run's batch 0 reads the
        state the uninterrupted run had when it planned ``start_batch``.

        ``entries[k][rung]`` holds what :meth:`post` received for batch
        k. Observations posted but not yet applied at the resume point
        are re-indexed into the resumed run's batch space, so the lag
        schedule continues where it stopped."""
        for k in range(start_batch):
            self.apply_upto(k - depth)
            for name, ob in sorted(entries[k].items()):
                if name not in self._controllers:
                    continue
                self.post(name, k, nbytes=ob["bytes"], frames=ob["frames"],
                          frame_qps=ob.get("qps"), cost=ob.get("cost"))
            if self.hunting():
                self.apply_upto(k)
        for dq in self._pending.values():
            shifted = [(k - start_batch, *rest) for (k, *rest) in dq]
            dq.clear()
            dq.extend(shifted)
