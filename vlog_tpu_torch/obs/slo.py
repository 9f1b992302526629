"""SLO plane: declarative objectives evaluated as multi-window burn rates
(a copy of ``vlog_tpu/obs/slo.py``).

The metrics plane (obs/metrics.py) records everything and interprets
nothing. This module is the Monarch-style rollup on top: a small,
declarative registry of service-level objectives — one per plane's
user-visible promise — each evaluated as an **error ratio** (fraction
of events outside the objective's threshold) over two sliding windows,
and turned into a **burn rate** (error ratio over the error budget
``1 - target``). A burn rate of 1.0 means the plane is spending its
budget exactly at the sustainable rate; an objective *alerts* while
both windows burn at or above ``VLOG_SLO_BURN_ALERT`` — the classic
multi-window multi-burn rule, so a 10-second blip (fast window only)
and a slow background bleed (slow window only) both stay quiet while a
sustained acute burn pages.

Three source kinds cover every objective without new instrumentation:

- ``histogram`` — a cumulative runtime-registry histogram. Good events
  are observations at or under the threshold (read from the bucket
  counts; the threshold snaps to the nearest bucket bound at or above
  the requested value). Windowing comes from a bounded ring of
  cumulative snapshots taken at each evaluation tick.
- ``counter`` — a labeled runtime-registry counter where some label
  values are failures (e.g. ``vlog_delivery_requests_total`` outcome
  ``shed``). Same snapshot-delta windowing.
- ``span`` — named ``job_spans`` rows (obs/store.py), windowed directly
  in SQL over ``started_at``. Span objectives are also the exemplar
  source: rows over the threshold carry a ``trace_id`` that resolves
  through ``GET /api/jobs/{id}/trace``, so a burning objective links
  straight to the waterfall of a job that burned it.

Evaluation results are exported as the ``vlog_slo_*`` gauge families,
served by ``GET /api/slo`` (admin + worker APIs), and read back by the
fleet autoscale signal: :func:`alerting_objectives` is sync and cheap,
and ``jobs/qos.fleet_snapshot`` floors the scale hint at +1 while any
objective alerts (a burning SLO means the fleet is behind even if the
instantaneous backlog looks small).

The two delivery objectives read the delivery plane's families
(``vlog_delivery_fill_seconds``, ``vlog_delivery_requests_total``), so
they count the fills and sheds of the process's public app.

Everything here is best-effort observability: evaluation never raises
into callers, the exemplar ring is bounded (``VLOG_SLO_EXEMPLARS``),
and the snapshot ring is pruned past the slow window.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from vlog_tpu_torch import config

log = logging.getLogger("vlog_tpu_torch.slo")

WINDOWS = ("fast", "slow")


def _window_s(window: str) -> float:
    return (config.SLO_FAST_WINDOW_S if window == "fast"
            else config.SLO_SLOW_WINDOW_S)


@dataclass(frozen=True)
class Objective:
    """One declarative objective. ``target`` is the good-event fraction
    the plane promises (error budget = ``1 - target``)."""

    name: str                 # e.g. "jobs.queue_wait" (stable label)
    plane: str                # jobs | asr | delivery | ...
    description: str
    target: float             # e.g. 0.99
    kind: str                 # histogram | counter | gauge | span
    family: str = ""          # runtime() attribute (histogram/counter/gauge)
    threshold_s: float = 0.0  # latency bound (histogram/span kinds)
    bad_values: tuple[str, ...] = ()   # failing label values (counter kind)
    low: float | None = None  # gauge kind: bad while sampled value < low
    span_name: str = ""       # span kind: job_spans name

    @property
    def budget(self) -> float:
        return max(1e-6, 1.0 - self.target)


# The fleet's promises, one per plane surface. Latency thresholds are
# chosen to sit on existing histogram bucket bounds (obs/metrics.py)
# so bucket-count arithmetic is exact, and span thresholds reuse the
# QoS starvation bound — the SLO plane must agree with the claim
# scheduler about what "too slow" means.
OBJECTIVES: tuple[Objective, ...] = (
    Objective(
        name="jobs.enqueue_ready",
        plane="jobs",
        description="Jobs reach a terminal state within 30 minutes of "
                    "enqueue (root-span duration)",
        target=0.95, kind="span", span_name="__root__",
        threshold_s=1800.0),
    Objective(
        name="jobs.queue_wait",
        plane="jobs",
        description="Claimable jobs wait under the starvation bound "
                    "before a worker claims them (queue.wait spans)",
        target=0.99, kind="span", span_name="queue.wait",
        threshold_s=config.QOS_STARVATION_S),
    Objective(
        name="jobs.claim_wait",
        plane="jobs",
        description="Enqueue-to-claim wait stays under 10 s across "
                    "tenants (vlog_tenant_claim_wait_seconds)",
        target=0.99, kind="histogram", family="tenant_claim_wait",
        threshold_s=10.0),
    Objective(
        name="asr.throughput",
        plane="asr",
        description="The ASR engine sustains at least 0.5 windows/s "
                    "while batches are flowing",
        target=0.90, kind="gauge", family="asr_windows_per_second",
        low=0.5),
    Objective(
        name="asr.occupancy",
        plane="asr",
        description="ASR batches stay at least half-packed with real "
                    "windows while batches are flowing",
        target=0.90, kind="gauge", family="asr_batch_occupancy",
        low=0.5),
    Objective(
        name="delivery.latency",
        plane="delivery",
        description="Cache fills complete within 250 ms "
                    "(vlog_delivery_fill_seconds, all sources)",
        target=0.99, kind="histogram", family="delivery_fill_seconds",
        threshold_s=0.25),
    Objective(
        name="delivery.errors",
        plane="delivery",
        description="Delivery requests are served, not shed "
                    "(vlog_delivery_requests_total outcome=shed)",
        target=0.999, kind="counter", family="delivery_requests",
        bad_values=("shed",)),
)


# --------------------------------------------------------------------------
# Cumulative (good, total) extraction from the runtime registry
# --------------------------------------------------------------------------

def _collect_samples(metric: Any) -> list:
    try:
        families = list(metric.collect())
    except Exception:   # noqa: BLE001 — noop metrics under no prometheus
        return []
    out = []
    for fam in families:
        out.extend(getattr(fam, "samples", ()))
    return out


def _histogram_cum(metric: Any, threshold_s: float) -> tuple[float, float]:
    """(good, total) from cumulative bucket counts across all label
    sets: good = observations in buckets with le >= threshold (the
    first bound at or above the requested threshold), total = +Inf."""
    good = total = 0.0
    best_le: float | None = None
    buckets: list[tuple[float, float]] = []
    for s in _collect_samples(metric):
        if not s.name.endswith("_bucket"):
            continue
        le = s.labels.get("le", "")
        if le in ("+Inf", "inf"):
            total += s.value
            continue
        try:
            bound = float(le)
        except ValueError:
            continue
        buckets.append((bound, s.value))
        if bound >= threshold_s and (best_le is None or bound < best_le):
            best_le = bound
    if best_le is None:       # threshold above every finite bucket
        return total, total
    good = sum(v for bound, v in buckets if bound == best_le)
    return good, total


def _counter_cum(metric: Any, bad_values: tuple[str, ...]) \
        -> tuple[float, float]:
    """(good, total) from a labeled counter: any first-label value in
    ``bad_values`` is a failure."""
    bad = total = 0.0
    for s in _collect_samples(metric):
        if not s.name.endswith("_total"):
            continue
        total += s.value
        if any(v in bad_values for v in s.labels.values()):
            bad += s.value
    return total - bad, total


# --------------------------------------------------------------------------
# The plane
# --------------------------------------------------------------------------

@dataclass
class Exemplar:
    objective: str
    trace_id: str
    job_id: int | None
    value_s: float
    at: float
    attrs: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {"objective": self.objective, "trace_id": self.trace_id,
                "job_id": self.job_id, "value_s": round(self.value_s, 3),
                "at": self.at, "attrs": self.attrs}


def _exemplar_ring() -> "deque[Exemplar]":
    return deque(maxlen=config.SLO_EXEMPLARS)


class SloPlane:
    """Snapshot ring + evaluation; one per process (see :func:`plane`)."""

    def __init__(self, objectives: tuple[Objective, ...] = OBJECTIVES):
        self.objectives = objectives
        self._lock = threading.Lock()             # lock-order: 38
        # ring of (wall_time, {objective: (good_cum, total_cum)});
        # guarded-by: _lock
        self._ring: deque[tuple[float, dict[str, tuple[float, float]]]] = \
            deque()
        # bounded exemplar ring (maxlen=config.SLO_EXEMPLARS)
        self._exemplars: deque[Exemplar] = _exemplar_ring()  # guarded-by: _lock
        self._exemplar_seen: deque[str] = deque(maxlen=256)
        self._last_report: dict | None = None     # guarded-by: _lock
        # gauge kinds accumulate their own good/total tick counts so
        # they window exactly like cumulative counters
        self._gauge_counts: dict[str, tuple[float, float]] = {}

    # ---- sampling ----------------------------------------------------

    def _registry_cum(self) -> dict[str, tuple[float, float]]:
        from vlog_tpu_torch.obs.metrics import runtime

        reg = runtime()
        out: dict[str, tuple[float, float]] = {}
        for obj in self.objectives:
            metric = getattr(reg, obj.family, None) if obj.family else None
            if obj.kind == "histogram":
                out[obj.name] = _histogram_cum(metric, obj.threshold_s)
            elif obj.kind == "counter":
                out[obj.name] = _counter_cum(metric, obj.bad_values)
            elif obj.kind == "gauge":
                good, total = self._gauge_counts.get(obj.name, (0.0, 0.0))
                value = self._gauge_value(metric)
                # value 0.0 = no batch has flowed (gauges are
                # last-batch observations) — vacuously good, skip
                if value is not None and value > 0.0:
                    total += 1.0
                    if obj.low is None or value >= obj.low:
                        good += 1.0
                self._gauge_counts[obj.name] = (good, total)
                out[obj.name] = (good, total)
        return out

    @staticmethod
    def _gauge_value(metric: Any) -> float | None:
        for s in _collect_samples(metric):
            return float(s.value)
        return None

    def tick(self) -> None:
        """Take one cumulative snapshot (sync; registry only)."""
        cum = self._registry_cum()
        now = time.time()
        keep_after = now - config.SLO_SLOW_WINDOW_S - 2 * max(
            1.0, config.SLO_EVAL_S)
        with self._lock:
            self._ring.append((now, cum))
            while self._ring and self._ring[0][0] < keep_after:
                self._ring.popleft()
            while len(self._ring) > 512:
                self._ring.popleft()

    def _window_delta(self, name: str, now: float, window_s: float) \
            -> tuple[float, float, float]:
        """(good_delta, total_delta, actual_window_s) vs the snapshot
        closest to ``now - window_s`` (oldest available if none that
        old — a fresh process reports over its own lifetime)."""
        with self._lock:
            ring = list(self._ring)
        if not ring:
            return 0.0, 0.0, 0.0
        cutoff = now - window_s
        base_t, base = ring[0]
        for t, cum in ring:
            if t <= cutoff:
                base_t, base = t, cum
            else:
                break
        cur = ring[-1][1]
        g0, t0 = base.get(name, (0.0, 0.0))
        g1, t1 = cur.get(name, (0.0, 0.0))
        # registry restarts (tests resetting the singleton) read as
        # negative deltas; clamp to the current cumulative value
        dg, dt = g1 - g0, t1 - t0
        if dt < 0 or dg < 0:
            dg, dt = g1, t1
        return dg, dt, max(0.0, now - base_t)

    # ---- span-kind SQL -----------------------------------------------

    async def _span_window(self, db: Any, obj: Objective, now: float,
                           window_s: float) -> tuple[float, float]:
        """(good, total) for a span objective over one SQL window.
        ``__root__`` selects root spans (parent IS NULL) — the
        enqueue→terminal duration close_root stamps."""
        if obj.span_name == "__root__":
            where = "parent_id IS NULL"
            params: dict = {}
        else:
            where = "name = :name"
            params = {"name": obj.span_name}
        row = await db.fetch_one(
            f"""
            SELECT COUNT(*) AS total,
                   SUM(CASE WHEN duration_s <= :thr THEN 1 ELSE 0 END)
                       AS good
            FROM job_spans
            WHERE {where} AND duration_s IS NOT NULL
              AND started_at > :cut
            """,
            {**params, "thr": obj.threshold_s, "cut": now - window_s})
        total = float(row["total"] or 0)
        good = float(row["good"] or 0)
        return good, total

    async def _capture_exemplars(self, db: Any, obj: Objective,
                                 now: float) -> None:
        """Pull a few slow outliers (rows over the threshold) into the
        bounded ring; each links to /api/jobs/{id}/trace."""
        if obj.span_name == "__root__":
            where = "parent_id IS NULL"
            params: dict = {}
        else:
            where = "name = :name"
            params = {"name": obj.span_name}
        rows = await db.fetch_all(
            f"""
            SELECT trace_id, job_id, duration_s, started_at, attributes
            FROM job_spans
            WHERE {where} AND duration_s > :thr
              AND started_at > :cut
            ORDER BY duration_s DESC LIMIT 4
            """,
            {**params, "thr": obj.threshold_s,
             "cut": now - config.SLO_FAST_WINDOW_S})
        from vlog_tpu_torch.obs.metrics import runtime
        import json as _json

        for r in rows:
            key = f"{obj.name}:{r['trace_id']}"
            with self._lock:
                if key in self._exemplar_seen:
                    continue
                self._exemplar_seen.append(key)
                try:
                    attrs = _json.loads(r["attributes"] or "{}")
                except ValueError:
                    attrs = {}
                self._exemplars.append(Exemplar(
                    objective=obj.name, trace_id=r["trace_id"],
                    job_id=r["job_id"], value_s=float(r["duration_s"]),
                    at=float(r["started_at"]), attrs=attrs))
            runtime().slo_exemplars.labels(obj.name).inc()

    # ---- evaluation --------------------------------------------------

    async def evaluate(self, db: Any) -> dict:
        """One full evaluation: tick, window every objective, export
        the vlog_slo_* gauges, and return the report dict
        (``GET /api/slo``'s body)."""
        from vlog_tpu_torch.obs.metrics import runtime

        self.tick()
        reg = runtime()
        now = time.time()
        out = []
        for obj in self.objectives:
            per_window: dict[str, dict] = {}
            alerting = True
            for window in WINDOWS:
                w = _window_s(window)
                if obj.kind == "span":
                    try:
                        good, total = await self._span_window(
                            db, obj, now, w)
                    except Exception:   # noqa: BLE001 — table may not
                        # exist yet on an embedder's partial schema
                        log.debug("span window failed for %s",
                                  obj.name, exc_info=True)
                        good = total = 0.0
                    actual_w = w
                else:
                    good, total, actual_w = self._window_delta(
                        obj.name, now, w)
                err = (1.0 - good / total) if total > 0 else 0.0
                burn = err / obj.budget
                per_window[window] = {
                    "window_s": w,
                    "observed_window_s": round(actual_w, 1),
                    "events": int(total),
                    "error_ratio": round(err, 6),
                    "burn_rate": round(burn, 4),
                }
                reg.slo_error_ratio.labels(obj.name, window).set(err)
                reg.slo_burn_rate.labels(obj.name, window).set(burn)
                if burn < config.SLO_BURN_ALERT or total <= 0:
                    alerting = False
            reg.slo_alert.labels(obj.name).set(1.0 if alerting else 0.0)
            if obj.kind == "span":
                try:
                    await self._capture_exemplars(db, obj, now)
                except Exception:   # noqa: BLE001 — exemplars are garnish
                    log.debug("exemplar capture failed for %s",
                              obj.name, exc_info=True)
            out.append({
                "name": obj.name,
                "plane": obj.plane,
                "description": obj.description,
                "target": obj.target,
                "kind": obj.kind,
                "threshold_s": obj.threshold_s or None,
                "windows": per_window,
                "alerting": alerting,
            })
        with self._lock:
            exemplars = [e.as_dict() for e in self._exemplars]
        report = {
            "computed_at": now,
            "burn_alert_threshold": config.SLO_BURN_ALERT,
            "windows": {"fast": config.SLO_FAST_WINDOW_S,
                        "slow": config.SLO_SLOW_WINDOW_S},
            "objectives": out,
            "exemplars": exemplars,
        }
        with self._lock:
            self._last_report = report
        return report

    def last_report(self) -> dict | None:
        with self._lock:
            return self._last_report

    def alerting(self) -> list[str]:
        """Objective names alerting as of the last evaluation (sync —
        the scale-hint path must not re-evaluate)."""
        with self._lock:
            report = self._last_report
        if not report:
            return []
        return [o["name"] for o in report["objectives"] if o["alerting"]]


_plane: SloPlane | None = None
_plane_lock = threading.Lock()


def plane() -> SloPlane:
    """The process-wide SLO plane (lazy singleton, runtime() idiom)."""
    global _plane
    if _plane is None:
        with _plane_lock:
            if _plane is None:
                _plane = SloPlane()
    return _plane


def reset_plane() -> None:
    """Test hook: drop the singleton (fresh ring + exemplars)."""
    global _plane
    with _plane_lock:
        _plane = None


def alerting_objectives() -> list[str]:
    """Sync view of alerting objectives for the scale-hint path; never
    raises and never touches the database."""
    try:
        return plane().alerting()
    except Exception:   # noqa: BLE001 — observability must not break qos
        return []


async def eval_loop(db: Any, sink: Any = None) -> None:
    """Background evaluation (admin process): keeps the burn windows
    populated between scrapes and fires one rate-limited webhook per
    alerting objective. ``VLOG_SLO_EVAL_S=0`` disables the loop;
    ``GET /api/slo`` still evaluates on demand."""
    interval = config.SLO_EVAL_S
    if interval <= 0:
        return
    while True:
        await asyncio.sleep(interval)
        try:
            report = await plane().evaluate(db)
            if sink is not None:
                for o in report["objectives"]:
                    if not o["alerting"]:
                        continue
                    fast = o["windows"]["fast"]["burn_rate"]
                    slow = o["windows"]["slow"]["burn_rate"]
                    await sink.send(
                        "slo_burn",
                        f"objective {o['name']} burning error budget at "
                        f"{fast}x (fast) / {slow}x (slow)",
                        {"objective": o["name"], "plane": o["plane"],
                         "target": o["target"],
                         "burn_fast": fast, "burn_slow": slow},
                        key=f"slo_burn:{o['name']}")
        except asyncio.CancelledError:
            raise
        except Exception:   # noqa: BLE001 — the loop must survive
            log.warning("slo evaluation failed", exc_info=True)
