"""One bounded profiler slice of a traced run (``--trace 1``): the
device's kernels in it, their busy time and idle gaps, and the breakdown.

A slice is one completion unit of the program (a ladder dispatch, an
engine tick), the first to start once the measured window has closed, so
the profiler's cost never lands in the window the per-layer metrics read:
the device is drained, ``torch.profiler`` records the unit, and the
device is drained again. The slice's length is the host's clock
from the profiler's start to its stop. Events are read from the raw
kineto records (``chip_smoke.py``'s reader: ``prof.events()`` builds an
event tree that takes minutes for 10^5 launches).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

BREAKDOWN_TOP = 10


@dataclass
class Slice:
    """What one profiled unit left: kernels as (name, start_us, dur_us),
    host operations as (name, start_us, dur_us), the slice's wall."""

    kernels: list[tuple[str, float, float]] = field(default_factory=list)
    host_ops: list[tuple[str, float, float]] = field(default_factory=list)
    wall_s: float = 0.0
    meta: dict = field(default_factory=dict)

    def busy_intervals(self) -> list[tuple[float, float]]:
        """Kernel intervals merged where they overlap (several streams)."""
        iv = sorted((s, s + d) for _, s, d in self.kernels)
        out: list[list[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    @property
    def kernel_s(self) -> float:
        """Kernel time summed (overlaps counted twice)."""
        return sum(d for _, _, d in self.kernels) / 1e6

    def idle_share(self) -> float | None:
        if self.wall_s <= 0 or not self.kernels:
            return None
        return max(0.0, 1.0 - self.busy_s / self.wall_s)

    def breakdown(self) -> dict:
        """The device operations that took most time, and the longest
        idle gaps between kernels named by the innermost host operation
        running at the gap's middle."""
        by_name: dict[str, float] = {}
        for n, _, d in self.kernels:
            by_name[n] = by_name.get(n, 0.0) + d / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_TOP]
        iv = self.busy_intervals()
        gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(iv, iv[1:])),
                      key=lambda g: g[0] - g[1])[:BREAKDOWN_TOP]
        named = []
        for lo, hi in gaps:
            mid = (lo + hi) / 2
            inner = [(d, n) for n, s, d in self.host_ops if s <= mid <= s + d]
            host = min(inner)[1] if inner else "no host operation recorded"
            named.append([f"host: {host}"[:120], (hi - lo) / 1e6])
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": named}


def _is_device(e, torch) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def read_profile(prof, torch) -> tuple[list, list]:
    kernels, host = [], []
    for e in prof.profiler.kineto_results.events():
        rec = (e.name(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
        (kernels if _is_device(e, torch) else host).append(rec)
    return kernels, host


class Profiler:
    """Records at most one slice per run, around the unit a driver picks;
    the first session of a process may come back empty, so ``warm()``
    takes one throwaway session during set-up."""

    def __init__(self, torch, enabled: bool):
        self.torch = torch
        self.enabled = enabled
        self.slice: Slice | None = None
        self._taken = None

    def _session(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    def warm(self, device) -> None:
        if not self.enabled:
            return
        torch = self.torch
        x = torch.ones(1 << 20, device=device)
        with self._session():
            x.mul_(1.0)
            torch.cuda.synchronize()

    @property
    def taken(self) -> bool:
        return self._taken is not None or self.slice is not None

    def record(self, fn, *args, meta: dict | None = None, **kw):
        """Run ``fn`` as the slice (drained before and after). Its events
        are read by :meth:`finish`, after the window: reading 10^5 of
        them takes seconds the window must not pay."""
        torch = self.torch
        torch.cuda.synchronize()
        with self._session() as prof:
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        meta = dict(meta or {}, stop_s=time.perf_counter() - t0 - wall)
        self._taken = (prof, wall, meta)
        return out

    def finish(self) -> None:
        if self._taken is None:
            return
        prof, wall, meta = self._taken
        self._taken = None
        kernels, host = read_profile(prof, self.torch)
        self.slice = Slice(kernels=kernels, host_ops=host, wall_s=wall,
                           meta=meta)
