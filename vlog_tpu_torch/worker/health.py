"""Worker liveness/readiness probes for orchestrators (a copy of
``vlog_tpu/worker/health.py``).

Reference parity: worker/health_server.py:22-144 — a tiny HTTP server in
the worker process: ``/health`` answers while the event loop is alive
(k8s livenessProbe), ``/ready`` additionally checks the worker's
dependencies (DB reachable for local daemons, API heartbeat age for
remote workers — the ffmpeg-present check maps to the accelerator
backend having initialized). Port via ``VLOG_WORKER_HEALTH_PORT``
(0 = disabled).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Awaitable, Callable

from aiohttp import web

log = logging.getLogger("vlog_tpu_torch.worker.health")

# async () -> (ready: bool, detail: str)
ReadyFn = Callable[[], Awaitable[tuple[bool, str]]]


def combine(*checks: ReadyFn) -> ReadyFn:
    """Readiness is the AND of every check; the first failure's detail
    wins (an orchestrator acts on one reason at a time)."""

    async def ready() -> tuple[bool, str]:
        for check in checks:
            ok, detail = await check()
            if not ok:
                return False, detail
        return True, "ok"

    return ready


def disk_check(path, *, label: str = "scratch") -> ReadyFn:
    """Degrade readiness under disk pressure (storage/integrity.py
    admission floor, VLOG_MIN_FREE_DISK_GB). A full worker is alive but
    must not receive work — exactly the liveness/readiness split."""

    async def ready() -> tuple[bool, str]:
        from vlog_tpu_torch import config
        from vlog_tpu_torch.storage import integrity

        if integrity.under_pressure(path):
            free = integrity.free_bytes(path)
            return False, (f"{label} disk pressure: {free} bytes free, "
                           f"floor {config.MIN_FREE_DISK_BYTES}")
        return True, "ok"

    return ready


def drain_check(drain) -> ReadyFn:
    """Degrade readiness while the worker drains (worker/drain.py): it
    is alive and flushing in-flight work, but the orchestrator must
    stop routing to it and must not count it toward capacity — the
    liveness/readiness split again, now for planned eviction."""

    async def ready() -> tuple[bool, str]:
        snap = drain.snapshot()
        if snap.get("active"):
            return False, (f"draining: {snap.get('reason') or 'requested'} "
                           f"({snap.get('grace_left_s', 0):.0f}s grace left)")
        return True, "ok"

    return ready


def breaker_check(breaker, *, label: str = "coordination plane") -> ReadyFn:
    """Degrade readiness while a brownout breaker (worker/brownout.py)
    is open: the worker is alive and probing on backoff, but routing it
    work (or counting it available for scale decisions) while its
    database/API is flapping only grows the retry herd."""

    async def ready() -> tuple[bool, str]:
        snap = breaker.snapshot()
        if snap.get("open"):
            return False, (f"{label} brownout: "
                           f"{snap.get('last_error') or 'unreachable'}")
        return True, "ok"

    return ready


class WorkerHealthServer:
    def __init__(self, ready_fn: ReadyFn, *, port: int | None = None,
                 host: str = "0.0.0.0"):
        self.ready_fn = ready_fn
        self.port = port if port is not None else int(
            os.environ.get("VLOG_WORKER_HEALTH_PORT", "0"))
        self.host = host
        self.started_at = time.time()
        self._runner: web.AppRunner | None = None

    async def start(self) -> bool:
        if not self.port:
            return False
        app = web.Application()
        app.router.add_get("/health", self._health)
        app.router.add_get("/ready", self._ready)
        app.router.add_get("/metrics", self._metrics)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        log.info("worker health server on :%d", self.port)
        return True

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    async def _health(self, request: web.Request) -> web.Response:
        return web.json_response({
            "ok": True, "uptime_s": round(time.time() - self.started_at, 1)})

    async def _ready(self, request: web.Request) -> web.Response:
        try:
            ok, detail = await self.ready_fn()
        except Exception as exc:  # noqa: BLE001 — readiness must not crash
            ok, detail = False, f"{type(exc).__name__}: {exc}"
        return web.json_response({"ready": ok, "detail": detail},
                                 status=200 if ok else 503)

    async def _metrics(self, request: web.Request) -> web.Response:
        """The worker process's share of the fleet's metrics: stage
        histograms, breaker/backoff, job lifecycle counts, GC totals,
        alert outcomes, failpoint fires (obs/metrics.py runtime
        registry). Worker daemons and remote workers have no HTTP app
        of their own — before this route they exported nothing."""
        from vlog_tpu_torch.obs.metrics import runtime

        return web.Response(text=runtime().render_text(),
                            content_type="text/plain")
