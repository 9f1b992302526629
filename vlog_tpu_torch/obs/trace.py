"""Dependency-light tracer: spans with ids, parents, attributes (a copy
of ``vlog_tpu/obs/trace.py``).

Design constraints (which is why this is ~200 lines and not an
OpenTelemetry dependency):

- **Context via contextvars** — ``span()`` nests correctly under both
  asyncio tasks and plain call stacks; each task/thread sees its own
  current span. Compute threads do not inherit contextvars, so callers
  crossing a thread boundary :func:`capture` the context first and
  :func:`attach` it inside the thread — the same explicit-propagation
  contract the HTTP hop uses (``X-Trace-Id`` / ``X-Parent-Span``).
- **Durations are monotonic** — ``started_at`` is epoch time (for the
  waterfall's absolute axis) but the duration is measured on
  ``perf_counter`` so a clock step cannot produce negative spans.
- **Collection is a buffer, not a global** — spans land in the
  :class:`TraceBuffer` carried by the active :class:`TraceContext`;
  with no context (or no buffer) a span still times and nests but is
  dropped on exit, so instrumentation is safe to leave on
  unconditionally. Persistence is the caller's job (the job-span store,
  the spans upload endpoint for remote workers).

Synthesized spans: :func:`record_run_stages` folds a backend
``RunResult.stage_s`` dict into child spans — the five classic stage
busy-sums become ``stage.*`` spans, per-rung consumer busy-sums
(``rung_<name>_s``, parallel/executor.py) become ``rung.*`` spans, and
the overlap gauges (pipeline_depth, host_occupancy, ...) become
attributes on the parent. Busy-sums are not intervals, so these spans
share the parent's ``started_at`` and carry ``synthetic: true``.
"""

from __future__ import annotations

import contextlib
import threading
import time
import uuid
from contextvars import ContextVar
from dataclasses import dataclass, field
from typing import Iterator

__all__ = [
    "Span", "TraceBuffer", "TraceContext", "new_id", "current", "capture",
    "attach", "span", "event", "record_run_stages",
]

# The five cumulative busy-seconds fields RunResult.stage_s has carried
# since the stage-decoupled executor; everything else in stage_s is
# either a per-rung busy-sum (rung_<name>_s) or an overlap gauge.
STAGE_KEYS = ("decode_wait_s", "compute_wait_s", "device_pull_s",
              "entropy_s", "package_s")


def new_id() -> str:
    """16-hex-char id (trace and span ids share the alphabet)."""
    return uuid.uuid4().hex[:16]


@dataclass
class Span:
    """One finished (or in-flight) operation in a trace."""

    trace_id: str
    span_id: str
    parent_id: str | None
    name: str
    started_at: float                    # epoch seconds (waterfall axis)
    duration_s: float | None = None      # None = instant marker / unknown
    status: str = "ok"                   # "ok" | "error"
    attrs: dict = field(default_factory=dict)

    def set_error(self, message: object) -> None:
        self.status = "error"
        self.attrs["error"] = str(message)[:500]

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "started_at": self.started_at,
            "duration_s": self.duration_s,
            "status": self.status,
            "attrs": self.attrs,
        }


class TraceBuffer:
    """Thread-safe collector of finished spans (one per job attempt)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._spans: list[Span] = []

    def add(self, span_: Span) -> None:
        with self._lock:
            self._spans.append(span_)

    def snapshot(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def drain(self) -> list[Span]:
        with self._lock:
            out, self._spans = self._spans, []
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


@dataclass
class TraceContext:
    """What crosses boundaries: the trace, the parent span, the sink."""

    trace_id: str
    span_id: str | None = None
    buffer: TraceBuffer | None = None


_CTX: ContextVar[TraceContext | None] = ContextVar("vlog_trace_ctx",
                                                   default=None)


def current() -> TraceContext | None:
    """The active trace context of this task/thread (None = untraced)."""
    return _CTX.get()


def capture() -> TraceContext | None:
    """Snapshot the context for hand-off to a compute thread."""
    return _CTX.get()


@contextlib.contextmanager
def attach(ctx: TraceContext | None) -> Iterator[TraceContext | None]:
    """Bind a captured/explicit context (None detaches — spans inside
    still nest among themselves but are dropped on exit)."""
    token = _CTX.set(ctx)
    try:
        yield ctx
    finally:
        _CTX.reset(token)


@contextlib.contextmanager
def span(name: str, **attrs: object) -> Iterator[Span]:
    """Open a child span of the current context (or a fresh root).

    On exit the duration is stamped from ``perf_counter``, an escaping
    exception marks the span ``error``, and the span is appended to the
    context's buffer. Handlers that swallow exceptions themselves tag
    failures explicitly via :meth:`Span.set_error`.
    """
    parent = _CTX.get()
    trace_id = parent.trace_id if parent is not None else new_id()
    buf = parent.buffer if parent is not None else None
    sp = Span(trace_id, new_id(),
              parent.span_id if parent is not None else None,
              name, time.time(), attrs={k: v for k, v in attrs.items()})
    t0 = time.perf_counter()
    token = _CTX.set(TraceContext(trace_id, sp.span_id, buf))
    try:
        yield sp
    except BaseException as exc:
        sp.set_error(f"{type(exc).__name__}: {exc}")
        raise
    finally:
        sp.duration_s = time.perf_counter() - t0
        _CTX.reset(token)
        if buf is not None:
            buf.add(sp)


def event(name: str, *, duration_s: float | None = None,
          parent: Span | None = None, started_at: float | None = None,
          status: str = "ok", **attrs: object) -> Span | None:
    """Append an already-measured span (no timing of its own).

    Used for synthesized stage/rung spans and for error markers in
    paths where the failure is handled (not raised through a ``span()``
    block). Returns None when nothing is collecting.
    """
    ctx = _CTX.get()
    if parent is not None:
        trace_id, parent_id = parent.trace_id, parent.span_id
    elif ctx is not None:
        trace_id, parent_id = ctx.trace_id, ctx.span_id
    else:
        return None
    buf = ctx.buffer if ctx is not None else None
    if buf is None:
        return None
    sp = Span(trace_id, new_id(), parent_id, name,
              started_at if started_at is not None else time.time(),
              duration_s=duration_s, status=status,
              attrs={k: v for k, v in attrs.items()})
    buf.add(sp)
    return sp


def record_run_stages(parent: Span, stage_s: dict | None) -> None:
    """Fold a ``RunResult.stage_s`` dict into the trace.

    - the five classic stage busy-sums -> ``stage.<name>`` child spans
      whose durations ARE the busy seconds;
    - per-rung consumer busy-sums (``rung_<name>_s``) -> ``rung.<name>``
      child spans, so the waterfall attributes time per ladder rung;
    - everything else (pipeline_depth, max_in_flight, host_occupancy,
      ...) -> attributes on ``parent``.
    """
    if not stage_s:
        return
    for key, val in stage_s.items():
        if key in STAGE_KEYS:
            event(f"stage.{key[:-2]}", duration_s=float(val), parent=parent,
                  started_at=parent.started_at, synthetic=True)
        elif key.startswith("rung_") and key.endswith("_s"):
            event(f"rung.{key[5:-2]}", duration_s=float(val), parent=parent,
                  started_at=parent.started_at, synthetic=True)
        else:
            parent.attrs[key] = val
