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
registry at ``/metrics``. Since the Worker API is ported it also holds
the families that server and the worker's own planes feed: the fleet
stage and rung histograms ingested from worker span reports, the SLO
plane's gauges (``obs/slo.py``) and the orphan GC's counters
(``storage/gc.py``).

:class:`Metrics` is the HTTP-plane registry, one per server app: request
and job counters of the Worker API, and at render time the database
gauge block (jobs by derived state, queue depth, workers online, the
per-tenant queue) followed by :func:`runtime`'s families.

``prometheus_client`` is optional: without it every metric object is a
no-op and renders are empty — metrics are observability, the runtime
works unchanged.
"""

from __future__ import annotations

import threading
import time
from typing import Any

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

from vlog_tpu_torch import config
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
        # Lock witness (utils/locktrace.py): per-lock wait/hold profiles,
        # labeled by the static lock-order name. Only populated while the
        # witness is installed; contention lives well under the
        # transcode-stage scale, so the buckets start at microseconds.
        _lock_buckets = (1e-5, 1e-4, 1e-3, 1e-2, 0.1, 0.5, 2.0, 10.0)
        self.lock_wait_seconds = Histogram(
            "vlog_lock_wait_seconds",
            "Seconds spent waiting to acquire a sanitized lock",
            ["lock"], buckets=_lock_buckets, registry=self.registry)
        self.lock_hold_seconds = Histogram(
            "vlog_lock_hold_seconds",
            "Seconds a sanitized lock was held per acquisition",
            ["lock"], buckets=_lock_buckets, registry=self.registry)
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
        # Delivery plane (delivery/): origin segment cache + admission.
        self.delivery_requests = Counter(
            "vlog_delivery_requests_total",
            "Delivery-plane media request outcomes "
            "(hit, l2_hit, peer_fill, miss, bypass, shed)",
            ["outcome"], registry=self.registry)
        self.delivery_bytes = Counter(
            "vlog_delivery_bytes_total",
            "Payload bytes produced by the delivery plane, by source "
            "(cache, l2, peer, disk)",
            ["source"], registry=self.registry)
        self.delivery_evictions = Counter(
            "vlog_delivery_evictions_total",
            "Segment-cache entries evicted to stay under the byte budget",
            registry=self.registry)
        self.delivery_collapses = Counter(
            "vlog_delivery_collapses_total",
            "Concurrent same-key misses collapsed onto one disk read",
            registry=self.registry)
        self.delivery_cache_bytes = Gauge(
            "vlog_delivery_cache_bytes",
            "Bytes currently held by the delivery segment cache",
            registry=self.registry)
        self.delivery_inflight_reads = Gauge(
            "vlog_delivery_inflight_reads",
            "Cache-fill disk reads currently in flight",
            registry=self.registry)
        # Distributed delivery tier: disk-backed L2, consistent-hash
        # peer fill, publish-time prewarm (delivery/{l2,ring,plane}.py).
        self.delivery_l2_requests = Counter(
            "vlog_delivery_l2_requests_total",
            "Disk L2 probe outcomes on L1 miss "
            "(hit, miss, corrupt — corrupt entries are deleted and "
            "refilled, never served)",
            ["outcome"], registry=self.registry)
        self.delivery_l2_bytes = Gauge(
            "vlog_delivery_l2_bytes",
            "Bytes currently held by the disk-backed delivery L2",
            registry=self.registry)
        self.delivery_l2_evictions = Counter(
            "vlog_delivery_l2_evictions_total",
            "Disk L2 entries evicted to stay under the byte budget",
            registry=self.registry)
        self.delivery_peer_fills = Counter(
            "vlog_delivery_peer_fills_total",
            "Consistent-hash peer fill outcomes (hit = digest-verified "
            "body from a ring peer; failures classified as transport / "
            "timeout / status / digest — only transport and timeout "
            "feed gossip suspicion, digest quarantines the liar; every "
            "failure degrades the fill to local disk)",
            ["outcome"], registry=self.registry)
        self.delivery_prewarm = Counter(
            "vlog_delivery_prewarm_total",
            "Publish-time prewarm segment outcomes (warmed, error)",
            ["outcome"], registry=self.registry)
        # Self-healing fabric: gossip membership, hedged fills, heat.
        self.delivery_fill_seconds = Histogram(
            "vlog_delivery_fill_seconds",
            "Cache-fill latency by winning source (l2, peer, disk, "
            "bypass) — the reservoir behind the p95-adaptive hedge "
            "budget",
            ["source"],
            buckets=(0.001, 0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0,
                     2.0, 5.0),
            registry=self.registry)
        self.delivery_hedges = Counter(
            "vlog_delivery_hedges_total",
            "Hedged peer-fill outcomes (launched = primary overran the "
            "hedge budget, win = hedge beat the primary, primary_win = "
            "primary finished first anyway; losers are cancelled and "
            "never cached)",
            ["outcome"], registry=self.registry)
        self.delivery_coalesced_fills = Counter(
            "vlog_delivery_coalesced_fills_total",
            "Cross-origin fill requests (carrying the fill-token "
            "header) that coalesced onto an already-in-flight local "
            "fill — the flash-crowd one-disk-read-fleet-wide proof",
            registry=self.registry)
        self.delivery_gossip_probes = Counter(
            "vlog_delivery_gossip_probes_total",
            "Gossip heartbeat probe outcomes (ok, fail, drop — drop is "
            "the delivery.gossip failpoint eating the heartbeat)",
            ["outcome"], registry=self.registry)
        self.delivery_ring_version = Gauge(
            "vlog_delivery_ring_version",
            "Version of the membership view the delivery ring was last "
            "rebuilt from (bumps on peer death, quarantine, join, "
            "rejoin)",
            registry=self.registry)
        self.delivery_l2_rescues = Counter(
            "vlog_delivery_l2_rescues_total",
            "Disk L2 eviction second-chances granted to entries of hot "
            "slugs (heat-aware eviction spill)",
            registry=self.registry)
        self.delivery_stale_state = Counter(
            "vlog_delivery_stale_state_total",
            "Publish-state answers served stale because the database "
            "was unavailable (coordination-plane brownout)",
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
            "rung=<name> = that rung's d2h pull; asr: rung='forward' = "
            "each engine tick's wall on the device's clock, nothing "
            "without CUDA) — read next to host_busy_s/host_occupancy for "
            "the d2h-vs-compute split",
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
        self.fleet_stage_seconds = Histogram(
            "vlog_fleet_stage_duration_seconds",
            "Per-stage busy seconds ingested from worker span reports",
            ["stage"], buckets=STAGE_BUCKETS, registry=self.registry)
        self.fleet_rung_seconds = Histogram(
            "vlog_fleet_rung_duration_seconds",
            "Per-rung consume busy seconds ingested from worker span reports",
            ["rung"], buckets=STAGE_BUCKETS, registry=self.registry)
        self.gc_runs = Counter(
            "vlog_gc_runs_total", "Orphan-GC sweeps run",
            registry=self.registry)
        self.gc_files_removed = Counter(
            "vlog_gc_files_removed_total", "Entries reclaimed by GC sweeps",
            registry=self.registry)
        self.gc_bytes_reclaimed = Counter(
            "vlog_gc_bytes_reclaimed_total", "Bytes reclaimed by GC sweeps",
            registry=self.registry)
        self.gc_errors = Counter(
            "vlog_gc_errors_total", "Errors hit during GC sweeps",
            registry=self.registry)
        self.slo_error_ratio = Gauge(
            "vlog_slo_error_ratio",
            "Fraction of an objective's events outside its threshold "
            "over each burn window (0 = budget untouched)",
            ["objective", "window"], registry=self.registry)
        self.slo_burn_rate = Gauge(
            "vlog_slo_burn_rate",
            "Error ratio over the objective's error budget per window "
            "(1.0 = burning budget exactly at the sustainable rate)",
            ["objective", "window"], registry=self.registry)
        self.slo_alert = Gauge(
            "vlog_slo_alert",
            "1 while an objective burns past VLOG_SLO_BURN_ALERT on "
            "BOTH windows (the multi-window page condition)",
            ["objective"], registry=self.registry)
        self.slo_exemplars = Counter(
            "vlog_slo_exemplars_total",
            "Slow-outlier exemplars captured by the SLO plane "
            "(each carries a trace_id resolvable via the job trace API)",
            ["objective"], registry=self.registry)
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


class Metrics:
    """HTTP-plane Prometheus registry (one per app, test-safe)."""

    def __init__(self) -> None:
        self.registry = CollectorRegistry()
        self.http_requests = Counter(
            "vlog_http_requests_total", "HTTP requests",
            ["method", "route", "status"], registry=self.registry)
        self.jobs_claimed = Counter(
            "vlog_jobs_claimed_total", "Jobs claimed over HTTP",
            ["kind"], registry=self.registry)
        self.jobs_completed = Counter(
            "vlog_jobs_completed_total", "Jobs completed over HTTP",
            ["kind"], registry=self.registry)
        self.jobs_failed = Counter(
            "vlog_jobs_failed_total", "Job failures reported over HTTP",
            ["kind"], registry=self.registry)
        self.bytes_uploaded = Counter(
            "vlog_upload_bytes_total", "Output bytes uploaded by workers",
            registry=self.registry)
        self.upload_digest_mismatch = Counter(
            "vlog_upload_digest_mismatch_total",
            "Uploads rejected for an X-Content-SHA256 mismatch (422)",
            registry=self.registry)
        self.upload_disk_rejected = Counter(
            "vlog_upload_disk_rejected_total",
            "Uploads rejected under disk pressure (507)",
            registry=self.registry)
        self.manifest_rejects = Counter(
            "vlog_manifest_verify_failures_total",
            "Completions rejected by outputs.json tree verification (422)",
            registry=self.registry)
        # DB-derived gauge block cache (VLOG_METRICS_DB_TTL_S): the
        # GROUP-BYs below are O(states)/O(tenants), but a 1 s scrape
        # interval across several scrapers still multiplies them — the
        # app registry and runtime registry stay live every scrape,
        # only the SQL block is reused inside the TTL.
        self._db_block: str | None = None
        self._db_block_expires = 0.0

    async def render(self, db: Any) -> str:
        """One scrape: app registry + DB gauges + the runtime registry.

        The job-state gauges aggregate in SQL (GROUP BY over the
        derived-state CASE) so scrape cost is O(states), not O(jobs) —
        and the whole DB block is additionally cached for
        ``VLOG_METRICS_DB_TTL_S`` so tight scrape intervals cannot
        become DB load.
        """
        text = generate_latest(self.registry).decode()
        now_mono = time.monotonic()
        if self._db_block is None or now_mono >= self._db_block_expires:
            self._db_block = await self._render_db_block(db)
            self._db_block_expires = now_mono + config.METRICS_DB_TTL_S
        return text + self._db_block + runtime().render_text()

    async def _render_db_block(self, db: Any) -> str:
        """The SQL-derived gauge families of one scrape (cacheable)."""
        # lazy: jobs/claims imports this module, so a module-level
        # jobs.state import would be circular when obs loads first
        from vlog_tpu_torch.db.core import now as db_now
        from vlog_tpu_torch.jobs import state as js

        t = db_now()
        state_rows = await db.fetch_all(
            f"SELECT {js.sql_state_case()} AS state, COUNT(*) AS n "
            "FROM jobs GROUP BY state", {"now": t})
        counts = {r["state"]: int(r["n"] or 0) for r in state_rows}
        lines = ["# HELP vlog_jobs Jobs by derived state",
                 "# TYPE vlog_jobs gauge"]
        for st, n in sorted(counts.items()):
            lines.append(f'vlog_jobs{{state="{st}"}} {n}')
        # flat queue-depth gauge: what the worker HPA scales on
        # (deploy/k8s/worker-autoscaling.yaml) — claimable work only;
        # jobs waiting out retry backoff are deliberately excluded (they
        # cannot be claimed yet, so they must not trigger scale-up)
        queued = (counts.get("unclaimed", 0) + counts.get("retrying", 0)
                  + counts.get("expired", 0))
        lines.append("# HELP vlog_jobs_queued Jobs waiting for a worker")
        lines.append("# TYPE vlog_jobs_queued gauge")
        lines.append(f"vlog_jobs_queued {queued}")
        online = await db.fetch_val(
            "SELECT COUNT(*) FROM workers WHERE last_heartbeat_at > :cut",
            {"cut": t - config.WORKER_OFFLINE_THRESHOLD_S})
        lines.append("# HELP vlog_workers_online Workers with a fresh heartbeat")
        lines.append("# TYPE vlog_workers_online gauge")
        lines.append(f"vlog_workers_online {online or 0}")
        # per-tenant queue pressure: one GROUP BY over tenant (the QoS
        # plane's admission + fair-share inputs, made scrapeable)
        tenant_rows = await db.fetch_all(
            f"""
            SELECT tenant,
                   SUM(CASE WHEN {js.SQL_CLAIMABLE} THEN 1 ELSE 0 END)
                       AS queued,
                   SUM(CASE WHEN {js.SQL_ACTIVELY_CLAIMED} THEN 1 ELSE 0 END)
                       AS inflight
            FROM jobs WHERE {js.SQL_NOT_TERMINAL}
            GROUP BY tenant ORDER BY tenant
            """, {"now": t})
        lines.append("# HELP vlog_tenant_queued Claimable jobs by tenant")
        lines.append("# TYPE vlog_tenant_queued gauge")
        for r in tenant_rows:
            lines.append(f'vlog_tenant_queued{{tenant="{r["tenant"]}"}} '
                         f'{int(r["queued"] or 0)}')
        lines.append("# HELP vlog_tenant_inflight Actively claimed jobs "
                     "by tenant")
        lines.append("# TYPE vlog_tenant_inflight gauge")
        for r in tenant_rows:
            lines.append(f'vlog_tenant_inflight{{tenant="{r["tenant"]}"}} '
                         f'{int(r["inflight"] or 0)}')
        return "\n".join(lines) + "\n"
