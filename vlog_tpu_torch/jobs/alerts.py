"""Operational alert webhooks with per-key rate limiting (a copy of
``vlog_tpu/jobs/alerts.py``).

Reference parity: worker/alerts.py:95-427 — fire-and-forget webhook
notifications for operational events (worker startup/shutdown, permanent
job failures, stale-job recovery), rate-limited per alert key so a
crash-looping job cannot flood the channel, with an in-process counter
for observability. Target URL comes from ``VLOG_ALERT_WEBHOOK_URL``;
unset = alerts disabled.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from dataclasses import dataclass, field

import aiohttp

log = logging.getLogger("vlog_tpu_torch.alerts")

DEFAULT_MIN_INTERVAL_S = 300.0
ALERT_TIMEOUT_S = 10.0


@dataclass
class AlertMetrics:
    sent: int = 0
    suppressed: int = 0
    errors: int = 0

    def bump(self, outcome: str) -> None:
        """Count an outcome here AND in the process metrics registry
        (``vlog_alerts_total{outcome}``) — these used to be write-only
        fields nothing ever scraped."""
        setattr(self, outcome, getattr(self, outcome) + 1)
        from vlog_tpu_torch.obs.metrics import runtime

        runtime().alerts.labels(
            {"errors": "error"}.get(outcome, outcome)).inc()


@dataclass
class AlertSink:
    """Rate-limited alert sender; safe to call from any coroutine."""

    url: str | None = field(
        default_factory=lambda: os.environ.get("VLOG_ALERT_WEBHOOK_URL"))
    min_interval_s: float = DEFAULT_MIN_INTERVAL_S
    source: str = "vlog-tpu"

    def __post_init__(self) -> None:
        self.metrics = AlertMetrics()
        self._last_sent: dict[str, float] = {}

    @property
    def enabled(self) -> bool:
        return bool(self.url)

    def _allowed(self, key: str) -> bool:
        now = time.monotonic()
        last = self._last_sent.get(key)
        if last is not None and now - last < self.min_interval_s:
            self.metrics.bump("suppressed")
            return False
        self._last_sent[key] = now
        return True

    async def send(self, alert: str, message: str,
                   details: dict | None = None, *,
                   key: str | None = None) -> bool:
        """POST one alert; returns True when actually sent."""
        if not self.enabled or not self._allowed(key or alert):
            return False
        body = json.dumps({
            "alert": alert,
            "message": message,
            "source": self.source,
            "timestamp": time.time(),
            "details": details or {},
        }).encode()
        try:
            timeout = aiohttp.ClientTimeout(total=ALERT_TIMEOUT_S)
            async with aiohttp.ClientSession(timeout=timeout) as s:
                async with s.post(self.url, data=body, headers={
                        "Content-Type": "application/json"}) as resp:
                    ok = 200 <= resp.status < 300
        except (aiohttp.ClientError, OSError, asyncio.TimeoutError) as exc:
            log.debug("alert %s failed: %s", alert, exc)
            ok = False
        if ok:
            self.metrics.bump("sent")
        else:
            self.metrics.bump("errors")
        return ok

    def send_fire_and_forget(self, alert: str, message: str,
                             details: dict | None = None, *,
                             key: str | None = None) -> None:
        """Schedule without awaiting (reference
        send_alert_fire_and_forget, alerts.py:193)."""
        if not self.enabled:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        task = loop.create_task(self.send(alert, message, details, key=key),
                                name="vlog-alert-send")
        task.add_done_callback(lambda t: t.exception())


async def check_tenant_queue_depth(db, sink: AlertSink, *,
                                   threshold: int | None = None) -> list[str]:
    """Alert per tenant whose claimable backlog crosses the threshold.

    One GROUP BY over tenant — the alert names the offending tenant
    (and fires independently per tenant, each under its own rate-limit
    key), so a single flooding tenant reads as THAT tenant's incident,
    not an anonymous global queue-depth number. Threshold comes from
    ``VLOG_QOS_ALERT_QUEUED`` (0 = disabled). Returns the tenants that
    crossed, for tests and the caller's logs.
    """
    from vlog_tpu_torch import config
    from vlog_tpu_torch.db.core import now as db_now
    from vlog_tpu_torch.jobs import state as js

    limit = config.QOS_ALERT_QUEUED if threshold is None else threshold
    if limit <= 0:
        return []
    rows = await db.fetch_all(
        f"""
        SELECT tenant, COUNT(*) AS n FROM jobs
        WHERE {js.SQL_CLAIMABLE}
        GROUP BY tenant HAVING COUNT(*) >= :limit
        ORDER BY n DESC
        """,
        {"now": db_now(), "limit": limit})
    offenders: list[str] = []
    for r in rows:
        tenant, n = r["tenant"], int(r["n"] or 0)
        offenders.append(tenant)
        await sink.send(
            "tenant_queue_depth",
            f"tenant {tenant!r} has {n} claimable jobs queued "
            f"(threshold {limit})",
            {"tenant": tenant, "queued": n, "threshold": limit},
            key=f"queue_depth:{tenant}")
    return offenders


async def queue_depth_loop(db, sink: AlertSink, *,
                           interval_s: float | None = None) -> None:
    """Periodic tenant queue-depth check (admin server background task)."""
    from vlog_tpu_torch import config

    wait = interval_s if interval_s is not None else config.QOS_ALERT_INTERVAL_S
    while True:
        await asyncio.sleep(wait)
        try:
            await check_tenant_queue_depth(db, sink)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — alerting never kills the server
            log.warning("tenant queue-depth check failed", exc_info=True)
