"""The worker daemon — turns the job library into a running system (port
of ``vlog_tpu/worker/daemon.py``: the same claim loop, failure plane and
job plane over the same schema, with the compute on the port's entry
points on a CUDA device).

Reference parity: worker/transcoder.py:3076-3276 (`worker_loop`): startup
recovery, claim → process → progress (extending the lease) → complete/fail,
graceful SIGTERM shutdown that hands in-flight work back to the pool, and a
heartbeat row so the fleet dashboard can see the worker. The compute runs in
a worker thread; cancellation (timeout / lost claim / shutdown) is
cooperative at GOP-batch granularity through the progress callback — the
same chunked-execution contract that makes device dispatches checkpointable
(SURVEY.md §7 hard part 3).

Failure domain hardening:

- A circuit breaker (worker/breaker.py) pauses claiming after
  ``VLOG_BREAKER_THRESHOLD`` consecutive compute failures; after
  ``VLOG_BREAKER_COOLDOWN`` seconds one half-open probe job decides
  whether to resume or keep waiting.
- A stall watchdog cancels in-flight compute whose progress has not
  advanced within ``VLOG_STALL_WINDOW`` seconds — catching work that
  renews its lease (progress writes) without ever moving ``done``
  forward. Stall cancels are classified ``stalled`` in job_failures.
- Failures are classified (enums.FailureClass) when reported through
  ``claims.fail_job``; chaos runs arm failpoints (utils/failpoints.py,
  site ``daemon.compute`` here) via ``VLOG_FAILPOINTS``.

Device: ``WorkerDaemon.device`` (default ``"cuda"``, which raises at
construction without CUDA; only tests pass ``"cpu"``) goes to
``process_video``, ``generate_sprites`` and ``transcribe_video``; a held
slot lease's device overrides it. Under a scheduler every device job
runs on a lease, so a device fault quarantines the lease's card and the
probe loop reinstates it; when a probe sweep fails with every device
quarantined (a sticky CUDA error poisons the process), the daemon
stops with ``mgmt.RESTART_EXIT_CODE`` so its supervisor restarts it
(ROADMAP Queue C item 15).

Run it: ``python -m vlog_tpu_torch.worker.daemon --name my-worker --db
sqlite:///path/vlog.db`` (the health server, alerts and webhooks it
wires need ``aiohttp``).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import contextvars
import json
import logging
import signal
import threading
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Awaitable, Callable

from vlog_tpu_torch import config
from vlog_tpu_torch.codecs import validate_codec_format
from vlog_tpu_torch.db.core import Database, Row, now as db_now, open_database
from vlog_tpu_torch.enums import AcceleratorKind, FailureClass, JobKind, VideoStatus
from vlog_tpu_torch.jobs import claims, state as js, videos as vids
from vlog_tpu_torch.utils import failpoints
from vlog_tpu_torch.worker.breaker import CircuitBreaker
from vlog_tpu_torch.worker.drain import (DRAIN_CANCEL_REASON, DrainState,
                                   PreemptionWatcher)
from vlog_tpu_torch.worker.watchdog import ComputeWatchdogMixin, JobCancelled

log = logging.getLogger("vlog_tpu_torch.worker")

__all__ = ["WorkerDaemon", "DaemonStats", "JobCancelled"]


@dataclass
class DaemonStats:
    claimed: int = 0
    completed: int = 0
    failed: int = 0
    released: int = 0
    last_error: str | None = None

    def bump(self, event: str, n: int = 1) -> None:
        """Count a lifecycle event here AND in the process metrics
        registry (``vlog_worker_jobs_total{event}``) — these used to be
        write-only fields only the stats command could see."""
        setattr(self, event, getattr(self, event) + n)
        from vlog_tpu_torch.obs.metrics import runtime

        runtime().worker_jobs.labels(event).inc(n)


# Async event hook: (event_name, payload) — wired to webhook delivery.
EventFn = Callable[[str, dict], Awaitable[None]]

# Per-job supervision context: with the mesh scheduler admitting several
# jobs at once, each job's asyncio task carries its own supervisor and
# slot ticket through these vars (asyncio.to_thread copies context, so
# the compute thread sees them too). Unset = the daemon's own fields —
# the single-job path and direct test calls are unchanged.
_SUP: contextvars.ContextVar["JobSupervisor | None"] = \
    contextvars.ContextVar("vlog_job_supervisor", default=None)
_TICKET: contextvars.ContextVar[Any] = \
    contextvars.ContextVar("vlog_job_slot_ticket", default=None)


class JobSupervisor(ComputeWatchdogMixin):
    """Per-job cancellation + stall-watchdog state.

    One instance per in-flight job, so concurrent slot jobs cancel and
    stall-track independently; ``request_stop`` broadcasts to every
    active supervisor. The daemon itself remains a
    :class:`ComputeWatchdogMixin` so code (and tests) that drive
    ``daemon._run_with_timeout`` / ``daemon._cancel`` directly keep
    working."""

    def __init__(self, daemon: "WorkerDaemon"):
        self.cancel_grace_s = daemon.cancel_grace_s
        self.stall_window_s = daemon.stall_window_s
        self.watchdog_tick_s = daemon.watchdog_tick_s
        self._cancel = threading.Event()
        self._cancel_reason = ""
        # THIS job's first recorded failure (per-job success detection:
        # the daemon-wide stats.failed counter moves under concurrent
        # slot jobs, so it cannot attribute an attempt's outcome)
        self.failed_error: str | None = None
        self._reset_watchdog()

    def cancel(self, reason: str) -> None:
        self._cancel_reason = self._cancel_reason or reason
        self._cancel.set()


def _release_frames(exc: BaseException) -> None:
    """Drop the locals of the finished frames a failed attempt's
    traceback holds, down its cause/context chain. The compute thread's
    frames (the run loop's batches, the executor's staged outputs) sit in
    reference cycles through the traceback (the executor keeps the
    failure it re-raised, the watchdog's task its exception), which only
    the cyclic collector frees: their device tensors would stay allocated
    on the card until it runs. Cleared here, they are freed when the
    attempt ends. (Frames still executing are left alone.)"""
    seen: set[int] = set()
    cur: BaseException | None = exc
    while cur is not None and id(cur) not in seen:
        seen.add(id(cur))
        traceback.clear_frames(cur.__traceback__)
        cur = cur.__cause__ or cur.__context__


def _cleanup_other_format(out_dir: Path, new_fmt: str) -> None:
    """After a format conversion, remove the replaced format's artifacts
    (stale manifest.mpd / init.mp4 / segments of the other container)."""
    if new_fmt == "hls_ts":
        (out_dir / "manifest.mpd").unlink(missing_ok=True)
        for rung_dir in out_dir.iterdir():
            if rung_dir.is_dir():
                (rung_dir / "init.mp4").unlink(missing_ok=True)
                for seg in rung_dir.glob("segment_*.m4s"):
                    seg.unlink(missing_ok=True)
        for adir in out_dir.glob("audio_*"):
            if adir.is_dir():
                import shutil as _shutil

                _shutil.rmtree(adir, ignore_errors=True)
    else:
        for rung_dir in out_dir.iterdir():
            if rung_dir.is_dir():
                for seg in rung_dir.glob("segment_*.ts"):
                    seg.unlink(missing_ok=True)


@dataclass
class WorkerDaemon(ComputeWatchdogMixin):
    db: Database
    name: str
    accelerator: AcceleratorKind = AcceleratorKind.TPU
    kinds: tuple[JobKind, ...] = (JobKind.TRANSCODE, JobKind.REENCODE,
                                  JobKind.SPRITE, JobKind.TRANSCRIPTION)
    video_dir: Path = field(default_factory=lambda: config.VIDEO_DIR)
    backend: Any = None                    # backends.Backend; lazy-selected
    # The jobs' device ("cuda" unless a test asks for "cpu"); a held slot
    # lease's device overrides it.
    device: str = "cuda"
    poll_interval_s: float = field(
        default_factory=lambda: config.WORKER_POLL_INTERVAL_S)
    heartbeat_interval_s: float = field(
        default_factory=lambda: float(config.HEARTBEAT_INTERVAL_S))
    progress_min_interval_s: float = 2.0   # DB-write rate limit (thread side)
    on_event: EventFn | None = None
    transcription_model_dir: str | None = None
    # Stall watchdog: cancel compute whose progress (frames done) has not
    # advanced within this window; 0 disables. Checked every watchdog tick.
    stall_window_s: float = field(
        default_factory=lambda: config.STALL_WINDOW_S)
    watchdog_tick_s: float = 1.0
    # Circuit breaker over the compute path; None builds one from config.
    breaker: CircuitBreaker | None = None
    # Coordination-plane brownout breaker (worker/brownout.py) pacing the
    # claim loop through transient DB faults; None builds one from config.
    db_breaker: Any = None
    # Mesh job scheduler (parallel/scheduler.py). _amain passes the
    # process-wide one whenever it builds a backend; None + VLOG_MESH_SLOTS
    # > 1 + a backend builds it lazily in run(); tests inject a
    # MeshScheduler directly. Without one the claim loop is the classic
    # one-job-at-a-time poll.
    scheduler: Any = None
    # Grace-budgeted drain (worker/drain.py): seconds between a
    # preemption notice / first SIGTERM and the force-cancel of
    # still-running jobs; the tick paces the drain supervisor loop.
    drain_grace_s: float = field(
        default_factory=lambda: config.DRAIN_GRACE_S)
    drain_tick_s: float = 0.2

    def __post_init__(self) -> None:
        from vlog_tpu_torch.device import resolve_device

        # no fallback: without CUDA only an explicit device="cpu" runs
        resolve_device(self.device)
        self.stats = DaemonStats()
        self.restart_requested = False     # restart verb → exit code 64
        self.disk_paused = False           # claiming paused by admission
        self._stop = asyncio.Event()
        self._cancel = threading.Event()   # aborts the in-flight compute
        self._cancel_reason = ""
        self._current_job_id: int | None = None
        self._active_sups: dict[int, JobSupervisor] = {}  # job id -> sup
        self._tasks: set[asyncio.Task] = set()            # slot job tasks
        self.drain = DrainState()
        self._drain_task: asyncio.Task | None = None
        if self.breaker is None:
            self.breaker = CircuitBreaker()
        if self.db_breaker is None:
            from vlog_tpu_torch.worker.brownout import CoordinationBreaker

            self.db_breaker = CoordinationBreaker(source="daemon")
        self._reset_watchdog()
        # recent-log ring so the get_logs command verb can answer
        # without a log file (utils/logring.py)
        from vlog_tpu_torch.utils.logring import install_ring

        install_ring()

    # -- lifecycle ---------------------------------------------------------

    def request_stop(self) -> None:
        """Signal-safe shutdown request: stop polling, abort in-flight work."""
        self._stop.set()
        self._cancel_reason = self._cancel_reason or "shutdown"
        self._cancel.set()
        for sup in list(self._active_sups.values()):
            sup.cancel("shutdown")

    def handle_termination(self) -> None:
        """SIGTERM policy: the first signal starts a grace-budgeted
        drain (bounded-loss eviction); a second one during the drain
        skips the grace window — ``kill -TERM`` twice always means now
        (in-flight claims are force-cancelled and released)."""
        if self._stop.is_set():
            return
        if self.drain.active:
            log.warning("second termination signal during drain: skipping "
                        "the grace window, force-cancelling now")
            self.request_stop()
        else:
            self.begin_drain("SIGTERM")

    def begin_drain(self, reason: str) -> bool:
        """Enter DRAINING: stop granting claims, let in-flight jobs
        finish and flush under heartbeat-extended leases, force-cancel
        at the grace deadline, then stop. False if already draining."""
        if not self.drain.begin(reason, self.drain_grace_s):
            return False
        from vlog_tpu_torch.obs.metrics import runtime

        runtime().worker_draining.set(1)
        log.warning("entering drain (%s): claiming stopped, %d in-flight "
                    "job(s), grace %.0fs", reason, len(self._active_sups),
                    self.drain_grace_s)
        self._drain_task = asyncio.create_task(self._drain_loop(),
                                              name="vlog-drain")
        return True

    async def _drain_loop(self) -> None:
        """The drain supervisor: lease heartbeats while jobs flush, the
        grace deadline, and the final stop once the worker is empty."""
        from vlog_tpu_torch.obs.metrics import runtime

        forced = False
        last_extend = 0.0
        try:
            try:
                await self._heartbeat()     # publish status='draining'
            except Exception:  # noqa: BLE001 — a DB flap must not skip
                # the drain itself
                log.exception("drain heartbeat failed; draining anyway")
            while not self._stop.is_set():
                if not self._active_sups and not self._tasks:
                    break
                if forced or self.drain.expired():
                    if not forced:
                        forced = True
                        log.warning(
                            "drain grace exhausted; force-cancelling %d "
                            "job(s)", len(self._active_sups))
                    # re-broadcast every tick (idempotent): a claim that
                    # raced begin_drain registers its supervisor after
                    # the first broadcast and must still be cancelled
                    self._cancel_reason = (self._cancel_reason
                                           or DRAIN_CANCEL_REASON)
                    self._cancel.set()
                    for sup in list(self._active_sups.values()):
                        sup.cancel(DRAIN_CANCEL_REASON)
                now = time.monotonic()
                if not forced and now - last_extend >= min(
                        self.heartbeat_interval_s, 10.0):
                    last_extend = now
                    await self._extend_drain_leases()
                with contextlib.suppress(asyncio.TimeoutError):
                    await asyncio.wait_for(self._stop.wait(),
                                           self.drain_tick_s)
        finally:
            runtime().worker_draining.set(0)
            runtime().drain_seconds.observe(self.drain.elapsed_s())
            log.info("drain complete in %.1fs (%s); stopping worker",
                     self.drain.elapsed_s(),
                     "deadline forced" if forced else "clean")
            self.request_stop()

    async def _extend_drain_leases(self) -> None:
        """Heartbeat-extend every in-flight claim so the expired-claim
        sweep cannot hand a draining job away mid-flush (compute may
        legitimately sit between progress posts while it drains)."""
        for job_id in list(self._active_sups):
            try:
                await claims.update_progress(self.db, job_id, self.name,
                                             extend_lease=True)
            except js.JobStateError as exc:
                # the claim is no longer ours (sweep/admin requeue raced
                # the drain): cancel that job now — keeping it running
                # only burns grace for writes that can never land
                log.warning("claim lost during drain (job %s): "
                            "cancelling: %s", job_id, exc)
                sup = self._active_sups.get(job_id)
                if sup is not None:
                    sup.cancel("claim lost during drain")
            except Exception:  # noqa: BLE001 — a flap must not kill the
                # drain loop; the next tick retries
                log.exception("drain lease extension failed for job %s",
                              job_id)

    async def _on_preemption_notice(self, reason: str) -> None:
        self.begin_drain(reason)

    def _sup(self) -> ComputeWatchdogMixin:
        """The supervisor for the current job context (self when none —
        the direct-call / legacy path)."""
        return _SUP.get() or self

    async def startup(self) -> None:
        """Recovery sweep + worker registration.

        Reference: transcoder.py:2017-2120 ``recover_interrupted_jobs`` —
        a restarted worker releases any claims a previous incarnation of
        itself still holds (the process died mid-job), then sweeps lapsed
        leases fleet-wide so those jobs are claimable again.
        """
        t = db_now()
        stale = await self.db.fetch_all(
            f"SELECT * FROM jobs WHERE claimed_by=:w AND {js.SQL_ACTIVELY_CLAIMED}",
            {"w": self.name, "now": t},
        )
        for row in stale:
            log.warning("recovering interrupted job %s (kind=%s)",
                        row["id"], row["kind"])
            # No attempt refund: the previous incarnation CRASHED mid-job.
            # Refunding would let a poison job that kills its worker retry
            # past max_attempts forever.
            await claims.release_job(self.db, row["id"], self.name,
                                     refund_attempt=False)
        await claims.sweep_expired_claims(self.db)
        await self._heartbeat()

    async def _heartbeat(self) -> None:
        caps = {}
        if self.backend is not None:
            try:
                caps = self.backend.detect().to_dict()
            except Exception:
                caps = {}
        await self.db.execute(
            """
            INSERT INTO workers (name, kind, accelerator, capabilities,
                                 code_version, last_heartbeat_at, created_at)
            VALUES (:n, 'local', :a, :c, :v, :t, :t)
            ON CONFLICT (name) DO UPDATE SET accelerator=:a, capabilities=:c,
                code_version=:v, last_heartbeat_at=:t, status=:st
            """,
            {"n": self.name, "a": self.accelerator.value,
             "c": json.dumps(caps), "v": config.CODE_VERSION, "t": db_now(),
             # 'draining' is a distinct fleet-visible state: online but
             # deliberately not claimable (admin workers table + stats)
             "st": "draining" if self.drain.active else "active"},
        )

    async def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            try:
                await asyncio.wait_for(self._stop.wait(),
                                       self.heartbeat_interval_s)
            except asyncio.TimeoutError:
                pass
            if not self._stop.is_set():
                try:
                    await self._heartbeat()
                    from vlog_tpu_torch.jobs import commands as cmds

                    await cmds.drain_for_worker(self.db, self.name,
                                                self.handle_command)
                except Exception:       # noqa: BLE001 — a transient DB
                    # error must not permanently kill the heartbeat task
                    log.exception("heartbeat write failed; will retry")

    async def handle_command(self, command: str, args: dict) -> dict:
        """Remote management commands (reference command_listener.py)."""
        if command == "ping":
            return {"pong": True, "worker": self.name}
        if command == "stats":
            from dataclasses import asdict

            from vlog_tpu_torch.jobs import qos

            try:
                # same snapshot GET /api/fleet/scale-hint serves — one
                # SQL helper, two surfaces
                fleet = await qos.fleet_snapshot(self.db)
            except Exception:  # noqa: BLE001 — stats must answer anyway
                log.warning("fleet snapshot unavailable", exc_info=True)
                fleet = None
            return {**asdict(self.stats),
                    "current_job_id": self._current_job_id,
                    "active_job_ids": sorted(self._active_sups),
                    "breaker": self.breaker.snapshot(),
                    "db_breaker": self.db_breaker.snapshot(),
                    "disk_paused": self.disk_paused,
                    "mesh": (self.scheduler.snapshot()
                             if self.scheduler is not None else None),
                    "draining": {**self.drain.snapshot(),
                                 "jobs_remaining": len(self._active_sups)},
                    "kinds": [k.value for k in self.kinds],
                    "fleet": fleet}
        if command == "drain":
            started = self.begin_drain("admin drain command")
            return {"draining": True, "started": started,
                    "grace_s": self.drain_grace_s,
                    "jobs_remaining": len(self._active_sups)}
        if command == "stop":
            log.info("remote stop command received")
            # Defer: the response must be written before shutdown starts
            # cancelling the heartbeat task that is writing it.
            asyncio.get_running_loop().call_later(0.5, self.request_stop)
            return {"stopping": True}
        from vlog_tpu_torch.worker import mgmt

        if command == "get_logs":
            return mgmt.get_logs(args)
        if command == "get_metrics":
            return mgmt.get_metrics({
                "worker": self.name, "current_job_id": self._current_job_id,
                "completed": self.stats.completed,
                "failed": self.stats.failed})
        if command == "profile":
            return mgmt.profile(args)
        if command == "restart":
            log.info("remote restart command received")
            self.restart_requested = True
            asyncio.get_running_loop().call_later(0.5, self.request_stop)
            return {"restarting": True,
                    "exit_code": mgmt.RESTART_EXIT_CODE}
        if command == "update":
            return {"error": "update is not supported: deploys are "
                             "image-based; roll the image and restart"}
        return {"error": f"unknown command {command!r}"}

    async def run(self) -> None:
        """Main loop: poll → claim → process, until ``request_stop``.

        Dispatch is event-driven with a poll safety net: between empty
        polls the loop sleeps on the job wakeup channel
        (jobs/events.py; LISTEN/NOTIFY on Postgres, in-process bus on
        sqlite), so enqueue→claim latency is milliseconds when events
        flow and at worst ``poll_interval_s`` when they don't."""
        from vlog_tpu_torch.jobs.events import CH_JOBS, bus_for

        try:
            await self.startup()
        except Exception:  # noqa: BLE001 — a failed recovery sweep must
            # not keep the worker down; the periodic sweep_loop below
            # (and the claim path's oldest-expiry probe) reclaims
            # lapsed leases anyway
            log.exception("startup recovery failed; polling anyway")
        if (self.scheduler is None and config.MESH_SLOTS > 1
                and self.backend is not None):
            from vlog_tpu_torch.parallel.scheduler import get_scheduler

            self.scheduler = get_scheduler()
            log.info("mesh scheduler active: %s", self.scheduler.snapshot())
        bus = bus_for(self.db)
        await bus.start()
        jobs_sub = bus.subscribe(CH_JOBS)
        hb = asyncio.create_task(self._heartbeat_loop(),
                                 name="vlog-heartbeat")
        # periodic expired-lease sweeper: with the per-claim sweep
        # reduced to an oldest-expiry probe, this loop is what reclaims
        # and dead-letters lapsed leases on an idle queue
        sweeper = asyncio.create_task(claims.sweep_loop(self.db, self._stop),
                                      name="vlog-lease-sweep")
        probe = None
        if self.scheduler is not None and config.DEVICE_PROBE_INTERVAL_S > 0:
            probe = asyncio.create_task(self._device_probe_loop(),
                                        name="vlog-device-probe")
        watcher = None
        pw = PreemptionWatcher.from_config()
        if pw is not None:
            watcher = asyncio.create_task(
                pw.watch(self._stop, self._on_preemption_notice),
                name="vlog-preempt-watch")
        try:
            while not self._stop.is_set():
                try:
                    worked = await self._poll_fill()
                    self.db_breaker.record_success()
                except Exception as exc:  # noqa: BLE001 — the daemon must
                    # outlive any single poll cycle (transient DB faults,
                    # injected failpoints)
                    from vlog_tpu_torch.db.retry import is_transient_db_error

                    worked = False
                    if is_transient_db_error(exc):
                        # coordination-plane brownout: jittered growing
                        # backoff instead of a fixed-pace reconnect herd;
                        # readiness degrades once the breaker opens
                        delay = self.db_breaker.record_error(exc)
                        # exc_info even on the paced path: if a code bug
                        # ever text-matches as transient, the traceback
                        # must still land in the log
                        log.warning("claim loop DB error (%s); backing "
                                    "off %.1fs", exc, delay, exc_info=True)
                        with contextlib.suppress(asyncio.TimeoutError):
                            await asyncio.wait_for(self._stop.wait(), delay)
                    else:
                        # pause briefly so a persistent fault cannot
                        # hot-loop
                        log.exception("poll cycle failed; continuing")
                        await asyncio.sleep(min(self.poll_interval_s, 1.0))
                if worked or self._stop.is_set():
                    # a poll that found work already consumed the queue
                    # head; stale wakeups would only cause a hot no-op
                    # loop, so clear them
                    jobs_sub.drain()
                    continue
                await self._idle_wait(jobs_sub)
        finally:
            jobs_sub.close()
            self._stop.set()
            if self._tasks:
                # in-flight slot jobs: request_stop already broadcast
                # the cancel; let each hand its claim back
                await asyncio.gather(*self._tasks, return_exceptions=True)
            if self._drain_task is not None:
                # the drain supervisor owns the drain_seconds accounting;
                # give it a moment to notice the stop and wind down
                await asyncio.gather(self._drain_task,
                                     return_exceptions=True)
            tasks = [t for t in (hb, sweeper, probe, watcher)
                     if t is not None]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await self.db.execute(
                "UPDATE workers SET status='offline' WHERE name=:n",
                {"n": self.name})

    async def _poll_fill(self) -> bool:
        """Admit work for every free mesh slot (the scheduler-aware claim
        loop). Without a scheduler this is exactly one blocking
        :meth:`poll_once`. With one, up to ``slots`` jobs are claimed
        while the scheduler reports capacity and each runs as its own
        task on its own slot lease. Unlike the JAX package's daemon, a
        one-slot scheduler takes this path too: one card is one slot,
        and only a job on a lease can quarantine its card on a device
        fault (with every device quarantined, ``slots`` is 0 and nothing
        is claimed until the probe reinstates one)."""
        if self.scheduler is None:
            return await self.poll_once()
        # capacity() rebuilds a partition that a quarantine or a probe's
        # reinstatement left dirty, so ``slots`` below is current (with
        # every device quarantined it reads 0 until a probe heals one)
        self.scheduler.capacity()
        device_kinds = (JobKind.TRANSCODE, JobKind.REENCODE)
        batch: list[tuple[Row, Any]] = []
        try:
            # The hold freezes slot grants for the round, making the
            # capacity check + claims + admissions atomic with respect
            # to width decisions: an earlier job's compute thread
            # cannot acquire against this round's incomplete demand
            # (grabbing the full mesh while another job is mid-claim,
            # or narrowing itself against a claim that returns empty).
            with self.scheduler.hold():
                while (not self._stop.is_set()
                       and (len(self._tasks) + len(batch)
                            < self.scheduler.slots)):
                    # Device jobs need slot capacity; CPU-only kinds
                    # (sprites) ride the same concurrency bound but
                    # never register device demand — a transcode
                    # claimed alongside one still work-conservingly
                    # gets the full mesh. Transcription is device
                    # demand too, but the shared ASR engine owns it:
                    # ONE scheduler ticket serves every transcription
                    # job, so transcription stays claimable with zero
                    # capacity as long as the engine is already
                    # serving (new jobs pile onto the running batch
                    # instead of queueing behind a slot). With zero
                    # capacity and an idle engine, device jobs and
                    # transcription both stay in the queue.
                    kinds = self.kinds
                    capacity = self.scheduler.capacity()
                    if capacity <= 0:
                        kinds = tuple(k for k in self.kinds
                                      if k not in device_kinds)
                        if not self._asr_engine_active():
                            kinds = tuple(k for k in kinds
                                          if k != JobKind.TRANSCRIPTION)
                        if not kinds:
                            break
                    # Batched claim: one transaction fills as many free
                    # slots as the queue can satisfy, instead of one
                    # claim transaction per slot. Bounded by remaining
                    # device capacity whenever the claim could return
                    # device kinds — the batch must never admit past
                    # what the (held) scheduler can grant.
                    want = (self.scheduler.slots - len(self._tasks)
                            - len(batch))
                    if capacity > 0 and any(k in device_kinds
                                            for k in kinds):
                        want = min(want, capacity)
                    # clamp to the claim layer's own cap so a short
                    # batch below really means the queue ran dry (and
                    # not that claim_jobs silently truncated the ask)
                    want = min(want, config.CLAIM_BATCH_MAX)
                    jobs = await self._admit_and_claim(kinds=kinds,
                                                       max_jobs=want)
                    if not jobs:
                        break
                    for job in jobs:
                        ticket = (self.scheduler.admit()
                                  if JobKind(job["kind"]) in device_kinds
                                  else None)
                        batch.append((job, ticket))
                    if len(jobs) < want:
                        break   # queue has no more eligible work now
        finally:
            for job, ticket in batch:
                task = asyncio.create_task(
                    self._run_slot_job(job, ticket),
                    name=f"vlog-slot-job-{job['id']}")
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
        return bool(batch)

    def _asr_engine_active(self) -> bool:
        """Is the shared ASR engine already serving (lease held or
        windows queued)? Never builds the engine — an idle worker must
        not page in Whisper weights from the claim loop."""
        from vlog_tpu_torch.asr.engine import peek_engine

        eng = peek_engine()
        return eng is not None and eng.active()

    async def _run_slot_job(self, job: Row, ticket: Any) -> None:
        """One slot job's task body: _process_claimed with the same
        outlive-any-job exception wall the legacy loop has — an escaped
        error (transient DB fault in dispatch bookkeeping) must be
        logged, not vanish into an unretrieved task exception."""
        try:
            await self._process_claimed(job, ticket)
        except Exception:  # noqa: BLE001 — the daemon must outlive any job
            log.exception("slot job %s failed outside the attempt wall",
                          job["id"])

    async def _device_probe_loop(self) -> None:
        """Periodically probe quarantined devices so healed hardware
        rejoins the slot rotation (``VLOG_DEVICE_PROBE_INTERVAL_S``)."""
        while not self._stop.is_set():
            try:
                await asyncio.wait_for(self._stop.wait(),
                                       config.DEVICE_PROBE_INTERVAL_S)
            except asyncio.TimeoutError:
                pass
            if self._stop.is_set():
                return
            try:
                if self.scheduler.quarantined_count():
                    results = await asyncio.to_thread(
                        self.scheduler.probe_quarantined)
                    healed = sum(1 for ok in results.values() if ok)
                    if healed:
                        log.info("device probe reinstated %d of %d "
                                 "quarantined devices", healed,
                                 len(results))
                    elif self.scheduler.snapshot()["slots"] == 0:
                        self._restart_for_sick_devices(len(results))
                        return
            except Exception:  # noqa: BLE001 — a failing probe sweep
                # must not kill the loop; the devices just stay out
                log.exception("device probe sweep failed")

    def _restart_for_sick_devices(self, n: int) -> None:
        """Every device is quarantined and the probe reinstated none. A
        sticky CUDA error (an illegal address, a device-side assert)
        poisons the process's CUDA context, so no in-process probe can
        pass again: take the ``restart`` verb's path (stop, exit with
        ``mgmt.RESTART_EXIT_CODE``) and let the supervisor start a fresh
        process (ROADMAP Queue C item 15)."""
        log.error("device probe failed on all %d quarantined device(s) "
                  "with no slot left; restarting the worker process", n)
        self.restart_requested = True
        self.request_stop()

    def _quarantine_for_fault(self, exc: BaseException) -> tuple:
        """After a device-classified fault, quarantine the faulting
        lease's devices (the slot renegotiates around the hole). Returns
        the newly quarantined devices (empty without a scheduler lease —
        direct calls and slots=1-without-scheduler have nothing to
        quarantine)."""
        ticket = _TICKET.get()
        lease = getattr(ticket, "lease", None)
        if self.scheduler is None or lease is None:
            return ()
        newly = self.scheduler.report_device_fault(lease, reason=str(exc))
        if newly:
            log.error("quarantined %d device(s) of slot %s after device "
                      "fault: %s", len(newly),
                      "full" if lease.is_full_mesh else lease.slot, exc)
        return newly

    async def _idle_wait(self, jobs_sub) -> None:
        """Sleep until a job event, the poll interval, shutdown, or — in
        slot mode — any in-flight job finishing (a freed slot means the
        loop should try to claim again)."""
        await jobs_sub.wait_or(self._stop, self.poll_interval_s,
                               extra=set(self._tasks))

    async def poll_once(self) -> bool:
        """Claim and process at most one job. Returns True if one ran."""
        jobs = await self._admit_and_claim()
        if not jobs:
            return False
        await self._process_claimed(jobs[0])
        return True

    async def _admit_and_claim(self, kinds: tuple[JobKind, ...] | None = None,
                               max_jobs: int = 1) -> list[Row]:
        """Admission gates (disk, breaker) + one claim attempt (up to
        ``max_jobs`` jobs in one transaction — _poll_fill's batch fill).
        Returns the claimed job rows, empty when nothing should run now.
        ``kinds`` narrows the claim (slot mode claims CPU-only kinds
        while a full-width lease saturates the mesh)."""
        from vlog_tpu_torch.db.retry import with_retries
        from vlog_tpu_torch.storage import integrity

        if self.drain.active:
            # draining: the scheduler grants no new slots — the whole
            # point is to empty this host before it disappears
            return []
        # Disk admission BEFORE the breaker: claiming with a full output
        # volume guarantees ENOSPC mid-write — burning an attempt (and,
        # in HALF_OPEN, the probe slot) to learn what a statvfs already
        # knows. The pause is transient by construction: GC or the
        # operator frees space and the next poll resumes.
        if integrity.under_pressure(self.video_dir):
            if not self.disk_paused:
                log.warning("output volume under disk pressure; pausing "
                            "claiming (%s)", self.video_dir)
            self.disk_paused = True
            return []
        self.disk_paused = False
        if not self.breaker.allow():
            # breaker open: leave the queue alone until the cooldown
            # lapses and a half-open probe is due
            return []
        # From here on, every exit that does not end in record_success /
        # record_failure must call release_probe() (a no-op unless this
        # poll holds the half-open probe) — otherwise the breaker wedges
        # in HALF_OPEN waiting for an outcome that can never arrive.
        try:
            jobs = await with_retries(
                lambda: claims.claim_jobs(
                    self.db, self.name,
                    kinds=self.kinds if kinds is None else kinds,
                    accelerator=self.accelerator, max_jobs=max_jobs),
                label="daemon-claim")
        except BaseException:
            self.breaker.release_probe()
            raise
        if not jobs:
            self.breaker.release_probe()
            return []
        if self._stop.is_set():
            # Shutdown arrived while the claim was in flight: hand every
            # job straight back instead of starting (and then
            # abandoning) work.
            self.breaker.release_probe()
            for job in jobs:
                try:
                    await claims.release_job(self.db, job["id"], self.name)
                except js.JobStateError:
                    pass
            return []
        return jobs

    async def _process_claimed(self, job: Row, ticket: Any = None) -> None:
        """Run one claimed job to its outcome under its own supervisor.
        ``ticket`` is the job's mesh-slot admission when the scheduler
        claimed it (closed here however the job ends, so a job that dies
        before compute cannot strand slot capacity)."""
        self.stats.bump("claimed")
        self._cancel.clear()
        self._cancel_reason = ""
        self._current_job_id = job["id"]
        self._reset_watchdog()
        sup = JobSupervisor(self)
        self._active_sups[job["id"]] = sup
        if self._stop.is_set():
            # request_stop raced the registration above: its broadcast
            # missed this supervisor, so deliver the cancel ourselves.
            sup.cancel("shutdown")
        tok_sup = _SUP.set(sup)
        tok_ticket = _TICKET.set(ticket)
        try:
            await self._dispatch(job)
        finally:
            _SUP.reset(tok_sup)
            _TICKET.reset(tok_ticket)
            self._active_sups.pop(job["id"], None)
            if ticket is not None:
                ticket.close()
            # Resolve any half-open probe _dispatch leaked — e.g. an
            # exception before its try block (video lookup) records no
            # outcome; a wedged HALF_OPEN would never claim again.
            self.breaker.release_probe()
            if self._current_job_id == job["id"]:
                self._current_job_id = None

    # -- job dispatch ------------------------------------------------------

    async def _dispatch(self, job: Row) -> None:
        kind = JobKind(job["kind"])
        video = await vids.get_video(self.db, job["video_id"])
        if video is None:
            await claims.fail_job(self.db, job["id"], self.name,
                                  "video row vanished", permanent=True)
            self.stats.bump("failed")
            return
        handler = {
            JobKind.TRANSCODE: self._run_transcode,
            JobKind.REENCODE: self._run_reencode,
            JobKind.SPRITE: self._run_sprites,
            JobKind.TRANSCRIPTION: self._run_transcription,
        }[kind]
        # Trace the attempt: a local daemon shares the server's DB, so
        # its spans (worker origin) go straight into job_spans under the
        # job's root span — the same tree a remote worker ships over
        # the spans endpoint.
        from vlog_tpu_torch.obs import store as obs_store, trace as obs_trace

        tctx = None
        stashed = job.pop("_trace", None)   # claim_job left us the root
        if config.TRACE_ENABLED and stashed is not None:
            tctx = obs_trace.TraceContext(stashed["trace_id"],
                                          stashed["parent_span_id"],
                                          obs_trace.TraceBuffer())
        elif config.TRACE_ENABLED:
            try:
                trace_id, root, _ = await obs_store.ensure_root(
                    self.db, job["id"], created_at=job["created_at"])
                tctx = obs_trace.TraceContext(trace_id, root,
                                              obs_trace.TraceBuffer())
            except Exception:  # noqa: BLE001 — a failed root mint must
                # not abandon the claimed job (it would idle to lease
                # expiry and be misattributed worker_crash); run untraced
                log.warning("trace root for job %s unavailable; running "
                            "untraced", job["id"], exc_info=True)
        try:
            with obs_trace.attach(tctx):
                await self._run_attempt(job, video, handler)
        finally:
            if tctx is not None:
                try:
                    await obs_store.record_spans(
                        self.db, job["id"], tctx.buffer.drain(),
                        trace_id=tctx.trace_id)
                except Exception:  # noqa: BLE001 — tracing must never
                    # take the worker down with the job
                    log.exception("span persistence failed for job %s",
                                  job["id"])

    async def _run_attempt(self, job: Row, video: Row, handler) -> None:
        from vlog_tpu_torch.obs import trace as obs_trace

        sup = _SUP.get()
        failed_before = self.stats.failed
        with obs_trace.span("worker.attempt", worker=self.name,
                            kind=job["kind"], attempt=job["attempt"]) as att:
            try:
                failpoints.hit("daemon.compute")
                await handler(job, video)
                # A handler can return normally after dead-lettering a DATA
                # problem internally (missing source, duration cap, bad
                # payload) — that says nothing about compute health, so it
                # must neither close a half-open breaker nor count against
                # it (poll_once's finally releases any probe). Only a run
                # with no failure recorded is a success. With a per-job
                # supervisor the failure marker is per-attempt; the
                # daemon-wide counter is only the direct-call fallback
                # (another slot job's failure must not be attributed here).
                if sup is not None:
                    ok, err = sup.failed_error is None, sup.failed_error
                else:
                    ok = self.stats.failed == failed_before
                    err = self.stats.last_error
                if ok:
                    self.breaker.record_success()
                else:
                    att.set_error(err or "dead-lettered")
            except JobCancelled as exc:
                _release_frames(exc)
                if exc.reason.startswith("preempted"):
                    # Drain deadline: the HOST is being evicted — not a
                    # compute-health event (no breaker), not the job's
                    # fault (PREEMPTED refunds the attempt, bounded).
                    # Whatever the executor flushed before the cancel
                    # stays on disk for the successor's resume scan.
                    obs_trace.event("worker.preempted", status="error",
                                    error=exc.reason,
                                    grace_s=self.drain_grace_s)
                    att.attrs["preempted"] = True
                    att.set_error(exc.reason)
                    await self._fail(job, video, exc.reason,
                                     failure_class=FailureClass.PREEMPTED)
                elif self._stop.is_set():
                    # Graceful shutdown: hand the claim back, attempt
                    # refunded. The lease may have lapsed (or been
                    # reclaimed) while the compute thread wound down — then
                    # there is nothing to release and the job is already
                    # claimable elsewhere.
                    try:
                        await claims.release_job(self.db, job["id"],
                                                 self.name)
                        att.attrs["released"] = True
                        self.stats.bump("released")
                        log.info("released job %s on shutdown", job["id"])
                    except js.JobStateError as rel_exc:
                        att.attrs["release_skipped"] = str(rel_exc)[:200]
                        log.warning("shutdown release of job %s skipped: %s",
                                    job["id"], rel_exc)
                else:
                    att.set_error(f"cancelled: {exc.reason}")
                    self.breaker.record_failure()
                    fc = (FailureClass.STALLED
                          if exc.reason.startswith("stalled")
                          else FailureClass.TRANSIENT)
                    await self._fail(job, video, f"cancelled: {exc.reason}",
                                     failure_class=fc)
            except js.JobStateError as exc:
                # Lost the claim (lease lapsed + reclaimed); nothing to
                # write. Not a breaker event: contention, not compute health.
                _release_frames(exc)
                att.set_error(f"claim lost: {exc}")
                log.warning("job %s claim lost: %s", job["id"], exc)
                self.stats.last_error = str(exc)
            except Exception as exc:  # noqa: BLE001 — worker must survive
                # any job
                from vlog_tpu_torch.parallel import faults

                att.set_error(f"{type(exc).__name__}: {exc}")
                log.exception("job %s failed", job["id"])
                _release_frames(exc)
                if faults.is_device_fault(exc):
                    # The HARDWARE failed the attempt, not the job: take
                    # the slot's devices out of rotation and requeue
                    # without burning the attempt budget (fail_job
                    # refunds DEVICE_FAULT). Quarantine — not the
                    # compute breaker — is the containment here: healthy
                    # slots must keep claiming while the sick chips sit
                    # out; the breaker still covers the no-scheduler
                    # case, where nothing else would stop the bleeding.
                    quarantined = self._quarantine_for_fault(exc)
                    att.attrs["device_fault"] = True
                    if not quarantined:
                        self.breaker.record_failure()
                    await self._fail(
                        job, video, f"{type(exc).__name__}: {exc}",
                        failure_class=FailureClass.DEVICE_FAULT)
                else:
                    self.breaker.record_failure()
                    await self._fail(job, video,
                                     f"{type(exc).__name__}: {exc}")

    def _mark_failed(self, error: str) -> None:
        """Record a failure against the CURRENT job's supervisor (the
        per-attempt outcome marker _run_attempt reads)."""
        sup = _SUP.get()
        if sup is not None and sup.failed_error is None:
            sup.failed_error = error

    async def _fail(self, job: Row, video: Row, error: str, *,
                    permanent: bool = False,
                    failure_class: FailureClass | None = None) -> None:
        row = await claims.fail_job(self.db, job["id"], self.name, error,
                                    permanent=permanent,
                                    failure_class=failure_class)
        self.stats.bump("failed")
        self.stats.last_error = error
        self._mark_failed(error)
        terminal = row["failed_at"] is not None
        if terminal and JobKind(job["kind"]) is JobKind.TRANSCODE:
            await vids.set_status(self.db, video["id"], VideoStatus.FAILED,
                                  error=error)
        await self._emit("job.failed" if not terminal else "job.failed_permanently",
                         {"job_id": job["id"], "video_id": video["id"],
                          "kind": job["kind"], "error": error})

    async def _emit(self, event: str, payload: dict) -> None:
        if self.on_event is not None:
            try:
                await self.on_event(event, payload)
            except Exception:
                log.exception("event hook failed for %s", event)

    # -- compute-thread plumbing ------------------------------------------

    def _make_progress_cb(self, job_id: int, total_hint: int,
                          rung_names: list[str]):
        """Progress callback run on the COMPUTE THREAD.

        Rate-limited DB writes via run_coroutine_threadsafe; every write
        extends the claim lease (reference worker_api.py:1747-1860). A lost
        claim or cancellation aborts the thread at the next batch boundary.
        """
        loop = asyncio.get_running_loop()
        last_write = 0.0
        claim_lost = threading.Event()
        sup = self._sup()   # this job's supervisor (or the daemon itself)

        async def write(progress: float, msg: str) -> None:
            try:
                await claims.update_progress(
                    self.db, job_id, self.name,
                    progress=progress, current_step=msg)
                for rn in rung_names:
                    await claims.upsert_quality_progress(
                        self.db, job_id, rn,
                        status="in_progress", progress=progress)
            except js.JobStateError:
                claim_lost.set()

        def cb(done: int, total: int, msg: str) -> None:
            nonlocal last_write
            sup._note_progress(done)   # stall-watchdog feed
            if sup._cancel.is_set():
                raise JobCancelled(sup._cancel_reason or "cancelled")
            if claim_lost.is_set():
                raise JobCancelled("claim lost (lease expired and reclaimed)")
            now = time.monotonic()
            if now - last_write < self.progress_min_interval_s and done < total:
                return
            last_write = now
            pct = 100.0 * done / max(total or total_hint, 1)
            asyncio.run_coroutine_threadsafe(write(min(pct, 99.0), msg), loop)

        return cb

    def _make_checkpoint_cb(self, job: Row):
        """ASR checkpoint callback run on the COMPUTE THREAD.

        Persists the cumulative resume state through the epoch-fenced
        ``jobs.last_checkpoint`` write (claims.update_progress carries
        the claim's attempt number as the fencing token, so a swept-and-
        reclaimed predecessor can never stomp the successor's state).
        Rate-limited like progress writes; the ``final`` flush — the
        drain path, after the in-flight batch drained — blocks until the
        row is written so a preempted attempt's completed windows survive
        the process."""
        loop = asyncio.get_running_loop()
        last_write = 0.0
        epoch = job["attempt"]

        async def write(state: dict) -> None:
            try:
                await claims.update_progress(
                    self.db, job["id"], self.name,
                    checkpoint={"asr": state}, epoch=epoch)
            except js.JobStateError:
                pass   # claim lost; the progress cb aborts the thread

        def cb(state: dict, done: int, total: int, final: bool) -> None:
            nonlocal last_write
            now = time.monotonic()
            if (not final and done < total
                    and now - last_write < self.progress_min_interval_s):
                return
            last_write = now
            fut = asyncio.run_coroutine_threadsafe(write(state), loop)
            if final:
                try:
                    fut.result(timeout=10.0)
                except Exception:  # noqa: BLE001 — drain deadline wins
                    pass

        return cb

    # Grace period for a cancelled compute thread to reach its next
    # progress-callback boundary before the daemon abandons it.
    cancel_grace_s: float = 120.0

    # _run_with_timeout / _cancel_and_drain: ComputeWatchdogMixin
    # (worker/watchdog.py) — shared with RemoteWorker so timeout, stall
    # and cancel semantics cannot drift between the two workers.

    @contextlib.contextmanager
    def _slot_scope(self):
        """Compute-thread scope around device work: blocks for this
        job's mesh slot lease and attaches it to the context, so the
        backend builds its mesh over the slot's devices and the shared
        entropy pool. No-op without a scheduler ticket — direct calls
        and slots=1 keep the classic full-mesh behavior. The wait
        honors the job's cancel flag (watchdog/timeout/shutdown), so a
        thread parked on a busy mesh aborts as a normal JobCancelled
        instead of being abandoned un-cancellably."""
        ticket = _TICKET.get()
        if ticket is None:
            yield None
            return
        from vlog_tpu_torch.parallel.scheduler import SlotCancelled

        sup = self._sup()
        try:
            lease = ticket.acquire(cancel=getattr(sup, "_cancel", None))
        except SlotCancelled as exc:
            raise JobCancelled(getattr(sup, "_cancel_reason", "")
                               or str(exc)) from exc
        with lease:
            yield lease

    def _job_device(self, lease):
        """The device a job's one-device work runs on (decode, audio,
        thumbnail, sprites): the lease's first device under a slot lease,
        whose (data x rung) grid the backend takes for the ladder; else
        the daemon's own ``device``."""
        if lease is None:
            return self.device
        from vlog_tpu_torch.parallel.scheduler import device_for_run

        return device_for_run(self.device)

    def _mesh_span_attrs(self, span) -> None:
        """Stamp the job's slot placement onto its transcode span."""
        ticket = _TICKET.get()
        lease = getattr(ticket, "lease", None)
        if lease is not None:
            span.attrs["mesh.slot"] = ("full" if lease.is_full_mesh
                                       else lease.slot)
            span.attrs["mesh.width"] = lease.width
            span.attrs["mesh.wait_s"] = round(lease.wait_s, 3)
            # the (data x rung) grid label the backend resolved for
            # this lease (grid_for_run stamps it during the run)
            if getattr(lease, "shape", None):
                span.attrs["mesh.shape"] = lease.shape

    # -- handlers ----------------------------------------------------------

    async def _run_transcode(self, job: Row, video: Row) -> None:
        from vlog_tpu_torch.media.probe import get_video_info
        from vlog_tpu_torch.worker.pipeline import process_video

        source = video["source_path"]
        if not source or not Path(source).exists():
            await self._fail(job, video, f"source missing: {source}")
            return
        await vids.set_status(self.db, video["id"], VideoStatus.PROCESSING)
        info = await asyncio.to_thread(get_video_info, source)
        if info.duration_s > config.MAX_VIDEO_DURATION_S:
            await claims.fail_job(self.db, job["id"], self.name,
                                  "video exceeds duration cap", permanent=True)
            await vids.set_status(self.db, video["id"], VideoStatus.FAILED,
                                  error="video exceeds duration cap")
            self.stats.bump("failed")
            self._mark_failed("video exceeds duration cap")
            return

        rungs = config.ladder_for_source(info.height)
        # One-pass ladder: the whole job runs under the heaviest rung's
        # timeout envelope (reference ran one ffmpeg per rung, each with
        # its own duration×multiplier timeout; config.py:247-260).
        timeout = config.transcode_timeout_s(info.duration_s, rungs[0].name)
        out_dir = self.video_dir / video["slug"]
        cb = self._make_progress_cb(job["id"], info.frame_count,
                                    [r.name for r in rungs])

        def work():
            with self._slot_scope() as lease:
                return process_video(source, out_dir, backend=self.backend,
                                     device=self._job_device(lease),
                                     progress_cb=cb, rungs=rungs)

        from vlog_tpu_torch.obs import trace as obs_trace
        from vlog_tpu_torch.obs.metrics import runtime as obs_runtime

        with obs_trace.span("worker.transcode",
                            rungs=[r.name for r in rungs]) as tsp:
            result = await self._sup()._run_with_timeout(
                work, timeout, "transcode")
            self._mesh_span_attrs(tsp)
        # stage busy-sums + per-rung times -> trace leaves; histograms
        # feed this process's /metrics on the worker health port
        obs_trace.record_run_stages(tsp, result.run.stage_s)
        obs_runtime().observe_run(result.run.stage_s)
        if result.run.resumed_segments:
            # bounded-loss accounting: segments a preempted (or crashed)
            # predecessor encoded that this attempt did NOT re-encode
            tsp.attrs["resumed_segments"] = result.run.resumed_segments
            obs_runtime().resume_segments_skipped.inc(
                result.run.resumed_segments)

        qualities = [
            {**q, "playlist_path": str(out_dir / q["quality"] / "playlist.m3u8")}
            for q in result.qualities
        ]
        from vlog_tpu_torch.jobs.finalize import finalize_transcode

        await finalize_transcode(
            self.db, job, video, probe=result.source, qualities=qualities,
            thumbnail_path=result.run.thumbnail_path)
        await claims.complete_job(self.db, job["id"], self.name)
        self.stats.bump("completed")
        await self._emit("video.ready", {
            "video_id": video["id"], "slug": video["slug"],
            "qualities": [q["quality"] for q in result.qualities]})

    async def _run_reencode(self, job: Row, video: Row) -> None:
        """Format/codec conversion job (reference reencode_worker.py:49-508:
        legacy HLS/TS -> CMAF and codec upgrades). The best source is the
        original upload when kept; the whole ladder re-runs with the
        requested parameters and the video row flips format atomically at
        finalize."""
        import json as _json

        from vlog_tpu_torch.media.probe import get_video_info
        from vlog_tpu_torch.worker.pipeline import process_video

        payload = _json.loads(job["payload"] or "{}")
        fmt = payload.get("streaming_format", "cmaf")
        codec = payload.get("codec", "h264")
        err = validate_codec_format(codec, fmt)
        if err is not None:
            await self._fail(job, video, err, permanent=True)
            return
        source = video["source_path"]
        if not source or not Path(source).exists():
            await self._fail(job, video, f"source missing: {source}")
            return
        info = await asyncio.to_thread(get_video_info, source)
        rungs = config.ladder_for_source(info.height)
        timeout = config.transcode_timeout_s(info.duration_s, rungs[0].name)
        out_dir = self.video_dir / video["slug"]
        cb = self._make_progress_cb(job["id"], info.frame_count,
                                    [r.name for r in rungs])

        def work():
            # resume=False: the output tree changes shape across formats.
            # write_manifest=False: the manifest is rebuilt below after
            # _cleanup_other_format anyway — hashing the tree twice
            # inside the timeout envelope would be pure waste.
            with self._slot_scope() as lease:
                return process_video(source, out_dir, backend=self.backend,
                                     device=self._job_device(lease),
                                     progress_cb=cb, rungs=rungs,
                                     resume=False, write_manifest=False,
                                     streaming_format=fmt, codec=codec)

        from vlog_tpu_torch.obs import trace as obs_trace
        from vlog_tpu_torch.obs.metrics import runtime as obs_runtime

        with obs_trace.span("worker.transcode", rungs=[r.name for r in rungs],
                            streaming_format=fmt, codec=codec) as tsp:
            result = await self._sup()._run_with_timeout(
                work, timeout, "reencode")
            self._mesh_span_attrs(tsp)
        obs_trace.record_run_stages(tsp, result.run.stage_s)
        obs_runtime().observe_run(result.run.stage_s)
        # Drop the previous format's leftovers so clients can never follow
        # stale manifests into a mixed tree.
        _cleanup_other_format(out_dir, fmt)
        # The integrity manifest process_video wrote described the
        # pre-cleanup tree — rebuild it so admin verify stays truthful.
        from vlog_tpu_torch.storage import integrity

        await asyncio.to_thread(
            lambda: integrity.write_manifest(
                out_dir, integrity.build_manifest(out_dir)))
        qualities = [
            {**q, "playlist_path": str(out_dir / q["quality"] / "playlist.m3u8")}
            for q in result.qualities
        ]
        from vlog_tpu_torch.jobs.finalize import finalize_transcode

        await finalize_transcode(
            self.db, job, video, probe=result.source, qualities=qualities,
            thumbnail_path=result.run.thumbnail_path,
            streaming_format=fmt, codec=codec, enqueue_downstream=False)
        await claims.complete_job(self.db, job["id"], self.name)
        self.stats.bump("completed")
        await self._emit("video.reencoded", {
            "video_id": video["id"], "slug": video["slug"],
            "streaming_format": fmt, "codec": codec})

    async def _run_sprites(self, job: Row, video: Row) -> None:
        from vlog_tpu_torch.worker.sprites import generate_sprites

        source = video["source_path"]
        if not source or not Path(source).exists():
            await self._fail(job, video, f"source missing: {source}")
            return
        out_dir = self.video_dir / video["slug"]
        cb = self._make_progress_cb(job["id"], 0, [])
        timeout = config.transcode_timeout_s(
            float(video["duration_s"] or 0.0), "360p")

        def work():
            return generate_sprites(source, out_dir, progress_cb=cb,
                                    device=self.device)

        result = await self._sup()._run_with_timeout(work, timeout, "sprites")
        await claims.complete_job(self.db, job["id"], self.name)
        self.stats.bump("completed")
        await self._emit("video.sprites_ready", {
            "video_id": video["id"], "slug": video["slug"],
            "sheets": result.sheet_count})

    async def _run_transcription(self, job: Row, video: Row) -> None:
        from vlog_tpu_torch.worker.transcribe import transcribe_video

        source = video["source_path"]
        if not source or not Path(source).exists():
            await self._fail(job, video, f"source missing: {source}")
            return
        await self.db.execute(
            "UPDATE videos SET transcription_status='in_progress', "
            "updated_at=:t WHERE id=:id",
            {"t": db_now(), "id": video["id"]})
        out_dir = self.video_dir / video["slug"]
        cb = self._make_progress_cb(job["id"], 0, [])
        ckpt_cb = self._make_checkpoint_cb(job)
        timeout = config.transcode_timeout_s(
            float(video["duration_s"] or 0.0), "720p")
        # A preempted/swept predecessor left its decoded windows in the
        # job row; this attempt re-submits only what is missing and
        # still produces a byte-identical VTT.
        try:
            prior = json.loads(job["last_checkpoint"] or "{}")
        except (TypeError, ValueError):
            prior = {}
        resume = prior.get("asr") if isinstance(prior, dict) else None
        model_dir = (self.transcription_model_dir or config.WHISPER_DIR
                     or None)
        asr_stats: dict[str, Any] = {}

        def work():
            engine = None
            if model_dir and Path(model_dir).exists() \
                    and self.scheduler is not None:
                # The shared engine owns the slot demand (one ticket for
                # every transcription job on this worker); without a
                # scheduler, transcribe_video builds the scheduler-less
                # engine itself (classic full-mesh behavior).
                from vlog_tpu_torch.asr.engine import get_engine

                engine = get_engine(model_dir, device=self.device,
                                    scheduler=self.scheduler)
            return transcribe_video(
                source, out_dir, progress_cb=cb,
                model_dir=self.transcription_model_dir,
                engine=engine, job_key=f"job-{job['id']}",
                checkpoint_cb=ckpt_cb, resume=resume,
                stats_out=asr_stats, device=self.device)

        from vlog_tpu_torch.obs import trace as obs_trace

        try:
            with obs_trace.span("worker.transcribe",
                                video_id=video["id"]) as tsp:
                result = await self._sup()._run_with_timeout(
                    work, timeout, "transcription")
                for k, v in asr_stats.items():
                    tsp.attrs[f"asr.{k}"] = v
        except js.JobStateError:
            # Claim lost: another worker owns this job now — do not stomp
            # whatever status it is writing.
            raise
        except JobCancelled:
            # Shutdown release -> job returns to the pool, so the video
            # goes back to pending; a real cancel (timeout) is a failure.
            status = "pending" if self._stop.is_set() else "failed"
            await self.db.execute(
                "UPDATE videos SET transcription_status=:s, updated_at=:t "
                "WHERE id=:id",
                {"s": status, "t": db_now(), "id": video["id"]})
            raise
        except Exception:
            await self.db.execute(
                "UPDATE videos SET transcription_status='failed', "
                "updated_at=:t WHERE id=:id",
                {"t": db_now(), "id": video["id"]})
            raise
        from vlog_tpu_torch.jobs.finalize import finalize_transcription

        await finalize_transcription(
            self.db, video["id"], language=result.language,
            model=result.model, vtt_path=result.vtt_path, text=result.text)
        await claims.complete_job(self.db, job["id"], self.name)
        self.stats.bump("completed")
        await self._emit("video.transcribed", {
            "video_id": video["id"], "slug": video["slug"],
            "language": result.language})


# --------------------------------------------------------------------------
# Entrypoint
# --------------------------------------------------------------------------

async def _amain(args: argparse.Namespace, *, device: str = "cuda") -> None:
    """The worker process: ``main``'s parsed options, on ``device`` (the
    card; only tests pass ``"cpu"``)."""
    from vlog_tpu_torch.db.schema import create_all

    config.ensure_dirs()
    db = open_database(args.db)
    await db.connect()
    await create_all(db)

    backend = scheduler = None
    if not args.no_backend:
        from vlog_tpu_torch.backends import select_backend
        from vlog_tpu_torch.parallel.scheduler import get_scheduler

        # both raise without CUDA: never a CPU fallback
        backend = select_backend(args.backend or None, device=device)
        # one card is one slot: every device job runs on a lease, so a
        # device fault quarantines its card and a sticky one (every
        # device out, the probe failing) restarts the process
        scheduler = get_scheduler()

    from vlog_tpu_torch.jobs.alerts import AlertSink
    from vlog_tpu_torch.jobs.webhooks import make_event_hook
    from vlog_tpu_torch.worker.health import WorkerHealthServer

    alerts = AlertSink(source=args.name)
    webhook_hook = make_event_hook(db)

    async def on_event(event: str, payload: dict) -> None:
        await webhook_hook(event, payload)
        if event == "job.failed_permanently":
            alerts.send_fire_and_forget(
                "job.failed_permanently",
                f"job {payload.get('job_id')} ({payload.get('kind')}) "
                f"exhausted retries: {payload.get('error')}",
                payload, key=f"jobfail:{payload.get('kind')}")

    daemon = WorkerDaemon(
        db, name=args.name,
        accelerator=AcceleratorKind(args.accelerator),
        kinds=tuple(JobKind(k) for k in args.kinds.split(",")),
        backend=backend, device=device, scheduler=scheduler,
        transcription_model_dir=args.whisper_dir,
        on_event=on_event,
    )

    async def db_ready() -> tuple[bool, str]:
        try:
            await db.fetch_val("SELECT 1")
        except Exception as exc:  # noqa: BLE001
            return False, f"db unreachable: {exc}"
        return True, "ok"

    from vlog_tpu_torch.worker.health import (breaker_check, combine, disk_check,
                                        drain_check)

    health = WorkerHealthServer(
        combine(db_ready, disk_check(daemon.video_dir, label="output"),
                breaker_check(daemon.db_breaker),
                drain_check(daemon.drain)))
    await health.start()
    loop = asyncio.get_running_loop()
    # SIGTERM = eviction notice: grace-budgeted drain (twice = now).
    # SIGINT stays immediate — an operator's ^C should not wait out a
    # drain window.
    loop.add_signal_handler(signal.SIGTERM, daemon.handle_termination)
    loop.add_signal_handler(signal.SIGINT, daemon.request_stop)
    log.info("worker %s starting (kinds=%s)", args.name, args.kinds)
    alerts.send_fire_and_forget("worker.startup",
                                f"worker {args.name} starting")
    try:
        await daemon.run()
    finally:
        await alerts.send("worker.shutdown",
                          f"worker {args.name} stopping: {daemon.stats}")
        await health.stop()
        await db.disconnect()
    if daemon.restart_requested:
        # cooperative restart (mgmt.py): the supervisor unit maps this
        # exit status to an immediate relaunch
        from vlog_tpu_torch.worker.mgmt import RESTART_EXIT_CODE

        raise SystemExit(RESTART_EXIT_CODE)
    log.info("worker %s stopped: %s", args.name, daemon.stats)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        description="vlog-tpu worker daemon (PyTorch/CUDA port)")
    parser.add_argument("--name", default=f"worker-{int(time.time())}")
    parser.add_argument("--db", default=config.DATABASE_URL)
    parser.add_argument("--accelerator", default="tpu",
                        choices=[a.value for a in AcceleratorKind])
    parser.add_argument("--kinds",
                        default="transcode,reencode,sprite,transcription")
    parser.add_argument("--backend", default="",
                        help="force a registered backend by name")
    parser.add_argument("--no-backend", action="store_true",
                        help="do not initialize an accelerator backend")
    parser.add_argument("--whisper-dir", default=None,
                        help="directory with Whisper weights (HF layout)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    asyncio.run(_amain(args))


if __name__ == "__main__":
    main()
