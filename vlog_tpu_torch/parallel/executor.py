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
