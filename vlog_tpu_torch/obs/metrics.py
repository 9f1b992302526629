"""The process-wide runtime metrics registry (the device runtime's part of
``vlog_tpu/obs/metrics.py``).

:func:`runtime` is ONE registry per process for what the device runtime
reports: per-stage and per-rung busy seconds of a transcode run, the
pipeline executor's overlap gauges and pad waste, the mesh scheduler's
slot and quarantine families, the ASR engine's batch families, the
device-seconds attribution, the profiler's session outcomes and
failpoint fires, and the worker's job plane: job lifecycle counts, the
compute and coordination breakers, retry backoff, drain, span writes,
alert outcomes, the per-tenant claim wait and the fleet scale hint. The
family names, help texts and labels are the reference's, so one
dashboard reads both packages. The worker's health server renders this
registry at ``/metrics``. The HTTP-plane registry (``Metrics``, which
renders database gauges for the API servers) is not ported (ROADMAP
Queue A item 13b).

``prometheus_client`` is optional: without it every metric object is a
no-op and renders are empty — metrics are observability, the runtime
works unchanged.
"""

from __future__ import annotations

import threading

try:
    from prometheus_client import (CollectorRegistry, Counter, Gauge,
                                   Histogram, generate_latest)
    HAVE_PROMETHEUS = True
except ImportError:  # pragma: no cover — exercised only in minimal envs
    HAVE_PROMETHEUS = False

    class CollectorRegistry:                       # type: ignore[no-redef]
        def collect(self):
            return []

    class _NoopMetric:
        def __init__(self, *args, **kwargs):
            pass

        def labels(self, *args, **kwargs):
            return self

        def inc(self, *args):
            pass

        def observe(self, *args):
            pass

        def set(self, *args):
            pass

    Counter = Gauge = Histogram = _NoopMetric      # type: ignore[misc]

    def generate_latest(_registry) -> bytes:       # type: ignore[no-redef]
        return b""

from vlog_tpu_torch.obs.trace import STAGE_KEYS
from vlog_tpu_torch.utils import failpoints

# Transcode stages run minutes at ladder scale; sub-second buckets catch
# the sprite/transcription tail.
STAGE_BUCKETS = (0.05, 0.25, 1.0, 5.0, 15.0, 60.0, 300.0, 1800.0)

_BREAKER_STATE_VALUES = {"closed": 0, "half_open": 1, "open": 2}


class RuntimeMetrics:
    """Process-wide registry (one per process; see :func:`runtime`)."""

    def __init__(self) -> None:
        self.registry = CollectorRegistry()
        self.stage_seconds = Histogram(
            "vlog_stage_duration_seconds",
            "Per-stage busy seconds of one transcode run "
            "(RunResult.stage_s fields)",
            ["stage"], buckets=STAGE_BUCKETS, registry=self.registry)
        self.rung_seconds = Histogram(
            "vlog_rung_duration_seconds",
            "Per-rung consume busy seconds of one transcode run",
            ["rung"], buckets=STAGE_BUCKETS, registry=self.registry)
        self.pipeline_gauges = Gauge(
            "vlog_pipeline_gauge",
            "Last run's pipeline overlap gauges (pipeline_depth, "
            "max_in_flight, host_busy_s, host_wall_s, host_occupancy)",
            ["name"], registry=self.registry)
        self.failpoint_fires = Counter(
            "vlog_failpoint_fires_total", "Armed failpoint fires by site",
            ["site"], registry=self.registry)
        self.resume_segments_skipped = Counter(
            "vlog_resume_segments_skipped_total",
            "Ladder segments accepted from a verified partial tree by "
            "resume instead of re-encoded (summed across rungs)",
            registry=self.registry)
        # Mesh job scheduler (parallel/scheduler.py): slot arbitration
        # over the process's devices.
        self.mesh_slots = Gauge(
            "vlog_mesh_slots",
            "Configured mesh job slots (VLOG_MESH_SLOTS, clamped to the "
            "device count)",
            registry=self.registry)
        self.mesh_slot_occupancy = Gauge(
            "vlog_mesh_slot_occupancy",
            "Mesh slot leases currently held by running jobs",
            registry=self.registry)
        self.mesh_slot_width = Gauge(
            "vlog_mesh_slot_width",
            "Devices held by each active slot lease (0 = slot free; "
            "slot label \"full\" is the work-conserving full-mesh lease)",
            ["slot"], registry=self.registry)
        self.mesh_slot_wait = Histogram(
            "vlog_mesh_slot_wait_seconds",
            "Seconds a claimed job waited for a mesh slot lease "
            "(queue-wait-for-slot)",
            buckets=(0.001, 0.01, 0.1, 0.5, 2.0, 10.0, 60.0, 300.0),
            registry=self.registry)
        self.ladder_pad_waste = Gauge(
            "vlog_ladder_pad_waste",
            "Padded fraction of the last ladder dispatch's staged frames "
            "(pad_batch rounds batches to the grid's data-axis width; the "
            "2-D (data x rung) layout narrows that width on small batches)",
            registry=self.registry)
        # Device quarantine (parallel/scheduler.py).
        self.slot_quarantined = Counter(
            "vlog_slot_quarantined_total",
            "Slot quarantine events (device-fault classified failures "
            "that took the lease's devices out of rotation)",
            ["slot"], registry=self.registry)
        self.device_quarantined = Gauge(
            "vlog_device_quarantined",
            "Devices currently quarantined (awaiting a passing probe)",
            registry=self.registry)
        self.device_probe = Counter(
            "vlog_device_probe_total",
            "Quarantined-device reinstatement probe outcomes",
            ["outcome"], registry=self.registry)
        # Continuous-batching ASR plane (asr/engine.py).
        self.asr_batches = Counter(
            "vlog_asr_batches_total",
            "Batched decode forwards run by the ASR engine",
            ["result"], registry=self.registry)
        self.asr_windows = Counter(
            "vlog_asr_windows_total",
            "Windows through the ASR plane (decoded = engine forward; "
            "resumed = restored from a checkpoint without re-decoding; "
            "failed = lost to a batch failure)",
            ["result"], registry=self.registry)
        self.asr_batch_occupancy = Gauge(
            "vlog_asr_batch_occupancy",
            "Real windows / batch rows in the last engine batch (1.0 = "
            "perfectly packed)", registry=self.registry)
        self.asr_pad_waste = Gauge(
            "vlog_asr_pad_waste",
            "Zero-padded fraction of the last engine batch's rows",
            registry=self.registry)
        self.asr_windows_per_second = Gauge(
            "vlog_asr_windows_per_second",
            "Decode throughput of the last engine batch",
            registry=self.registry)
        self.asr_queue_wait = Histogram(
            "vlog_asr_queue_wait_seconds",
            "Seconds a window waited in the cross-job queue before its "
            "batch completed",
            buckets=(0.01, 0.05, 0.2, 1.0, 5.0, 20.0, 60.0, 300.0),
            registry=self.registry)
        # Device-time attribution and the on-demand profiler.
        self.device_seconds = Counter(
            "vlog_device_seconds",
            "Accelerator-attributed busy seconds per batch by plane and "
            "rung (ladder: rung='compute' = shared device compute wait, "
            "rung=<name> = that rung's d2h pull; asr: rung='forward') — "
            "read next to host_busy_s/host_occupancy for the d2h-vs-"
            "compute split",
            ["plane", "rung"], registry=self.registry)
        self.profile_sessions = Counter(
            "vlog_profile_sessions_total",
            "On-demand device profiler session outcomes "
            "(started, completed, rejected, error)",
            ["outcome"], registry=self.registry)
        # The worker's job plane (worker/daemon.py, worker/breaker.py,
        # worker/brownout.py, worker/drain.py, jobs/, obs/store.py).
        self.breaker_transitions = Counter(
            "vlog_breaker_transitions_total",
            "Circuit-breaker state transitions", ["state"],
            registry=self.registry)
        self.breaker_state = Gauge(
            "vlog_breaker_state",
            "Current breaker state (0 closed, 1 half-open, 2 open)",
            registry=self.registry)
        self.job_backoff = Counter(
            "vlog_job_backoff_total",
            "Failed attempts stamped with retry backoff (next_retry_at)",
            registry=self.registry)
        self.worker_jobs = Counter(
            "vlog_worker_jobs_total",
            "Worker job lifecycle events (DaemonStats fields)",
            ["event"], registry=self.registry)
        self.alerts = Counter(
            "vlog_alerts_total", "Alert webhook outcomes (AlertMetrics)",
            ["outcome"], registry=self.registry)
        self.spans_recorded = Counter(
            "vlog_spans_recorded_total", "Spans persisted to job_spans",
            ["origin"], registry=self.registry)
        self.claim_errors = Counter(
            "vlog_claim_errors_total",
            "Transient coordination-plane (DB/API) errors hit by worker "
            "claim loops", ["source"], registry=self.registry)
        self.claim_breaker_open = Gauge(
            "vlog_claim_breaker_open",
            "1 while the worker's coordination-plane brownout breaker "
            "is open", registry=self.registry)
        self.worker_draining = Gauge(
            "vlog_worker_draining",
            "1 while this worker is draining (preemption notice, "
            "SIGTERM, or admin drain)", registry=self.registry)
        self.drain_seconds = Histogram(
            "vlog_drain_seconds",
            "Seconds from drain start until every in-flight claim "
            "resolved (completed, flushed + requeued, or released)",
            buckets=(0.5, 2.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0),
            registry=self.registry)
        self.tenant_claim_wait = Histogram(
            "vlog_tenant_claim_wait_seconds",
            "Seconds between a job becoming claimable and its claim, "
            "by tenant (enqueue-to-claim wait)",
            ["tenant"],
            buckets=(0.01, 0.1, 0.5, 2.0, 10.0, 30.0, 120.0, 600.0),
            registry=self.registry)
        self.fleet_scale_hint = Gauge(
            "vlog_fleet_scale_hint",
            "Suggested worker-count delta from the fleet snapshot "
            "(positive = scale out; negative = safe to shrink)",
            registry=self.registry)
        # the fires counter sees every fire in the process, wherever the
        # site lives: failpoints stays dependency-free, we observe
        failpoints.add_observer(
            lambda site: self.failpoint_fires.labels(site).inc())

    def observe_run(self, stage_s: dict | None) -> None:
        """Feed one RunResult.stage_s into histograms + overlap gauges."""
        if not stage_s:
            return
        for key, val in stage_s.items():
            try:
                num = float(val)
            except (TypeError, ValueError):
                continue
            if key in STAGE_KEYS:
                self.stage_seconds.labels(key[:-2]).observe(num)
            elif key.startswith("rung_") and key.endswith("_s"):
                self.rung_seconds.labels(key[5:-2]).observe(num)
            else:
                self.pipeline_gauges.labels(key).set(num)

    def observe_breaker(self, state: str) -> None:
        """Record a breaker transition (worker/breaker.py calls this)."""
        self.breaker_transitions.labels(state).inc()
        self.breaker_state.set(_BREAKER_STATE_VALUES.get(state, -1))

    def render_text(self) -> str:
        return generate_latest(self.registry).decode()


_runtime: RuntimeMetrics | None = None
_runtime_lock = threading.Lock()


def runtime() -> RuntimeMetrics:
    """The process-wide runtime registry (lazy singleton)."""
    global _runtime
    if _runtime is None:
        with _runtime_lock:
            if _runtime is None:
                _runtime = RuntimeMetrics()
    return _runtime
