"""What every cell shares: the checkout's cache directories and the
program's environment, the measured window over completion events, the
check that JAX never loads, and the one result line.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# Every build and kernel cache of the program, at fixed paths inside the
# checkout: only a checkout's first run builds.
BUILD_DIR = ROOT / "benchmark" / "_build"
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "vlog_tpu")


def prepare_environment(env: dict[str, str]) -> None:
    """Point the program's caches into the checkout and apply a
    configuration's deployment settings. Runs before the program is
    imported (its ``config`` reads ``VLOG_*`` at import)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    os.environ["VLOG_COMPILE_CACHE_DIR"] = str(BUILD_DIR / "vlog")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD_DIR / "triton")
    # a library that could load JAX by itself is told not to
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for k, v in env.items():
        os.environ[k] = str(v)


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole: ``vlog_tpu_torch`` is not
    ``vlog_tpu``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN_MODULES)


class IsolationError(RuntimeError):
    """The run loaded JAX or the JAX package."""


def check_isolation(when: str) -> None:
    bad = forbidden_loaded()
    if bad:
        raise IsolationError(f"{when}: loaded {bad[:10]}")


@dataclass
class Window:
    """The measured window over completion events.

    ``add(t, amount)`` records a completion (host clock, seconds) of
    ``amount`` units of work. The window opens at the first event and
    closes at the last event no later than ``seconds`` after it; the rate
    is the work completed after the opening event up to the closing one,
    over the time between them, so a stall anywhere in between lowers it.
    """

    seconds: float
    events: list[tuple[float, float]] = field(default_factory=list)

    def add(self, t: float, amount: float) -> None:
        self.events.append((t, amount))

    @property
    def opened(self) -> float | None:
        return self.events[0][0] if self.events else None

    @property
    def deadline(self) -> float | None:
        return None if not self.events else self.events[0][0] + self.seconds

    def closed(self, now: float) -> bool:
        d = self.deadline
        return d is not None and now >= d

    def inside(self) -> list[tuple[float, float]]:
        """The events from the opening one to the closing one."""
        d = self.deadline
        return [] if d is None else [e for e in self.events if e[0] <= d]

    @property
    def span(self) -> tuple[float, float] | None:
        ev = self.inside()
        return (ev[0][0], ev[-1][0]) if len(ev) >= 2 else None

    def rate(self) -> float | None:
        ev = self.inside()
        if len(ev) < 2 or ev[-1][0] <= ev[0][0]:
            return None
        return sum(a for _, a in ev[1:]) / (ev[-1][0] - ev[0][0])


@dataclass
class Check:
    """One number compared with the reference, beside its limit: the run
    is correct when every value is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def device_info(torch, chips: int, trace: dict | None) -> dict:
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}
    if trace is not None:
        info["busy_s"] = trace["busy_s"]
        info["window_s"] = trace["window_s"]
    return info


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: list[Check],
                breakdown: dict | None = None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return json.dumps(out)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)

