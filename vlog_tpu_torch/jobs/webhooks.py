"""Webhook event fan-out and HMAC-signed delivery with backoff (a copy of
``vlog_tpu/jobs/webhooks.py``).

Reference parity: api/webhook_service.py — ``trigger_webhook_event``
creates one delivery row per matching endpoint (234-330), a background
worker drains pending rows (809-847), payloads are HMAC-SHA256 signed
(205-232), private-network targets are refused (SSRF guard, 143), and
failures retry with exponential backoff until the attempt budget is gone.

The DB is the queue (webhook_deliveries table), so any process can
trigger events — workers, the worker API's complete endpoint — while a
single deliverer (run inside the admin API, or standalone via
``python -m vlog_tpu_torch.jobs.webhooks``) performs the HTTP sends.
"""

from __future__ import annotations

import asyncio
import hashlib
import hmac
import ipaddress
import json
import logging
from dataclasses import dataclass
from urllib.parse import urlparse

import aiohttp
import aiohttp.abc

from vlog_tpu_torch import config
from vlog_tpu_torch.db.core import Database, Row, now as db_now, open_database

log = logging.getLogger("vlog_tpu_torch.webhooks")

MAX_DELIVERY_ATTEMPTS = 5
BACKOFF_BASE_S = 30.0
DELIVERY_TIMEOUT_S = 10.0
# a crashed deliverer's in-flight claims return to the pool after this
INFLIGHT_LEASE_S = 300.0
SIGNATURE_HEADER = "X-VLog-Signature"


def sign_payload(secret: str, body: bytes) -> str:
    mac = hmac.new(secret.encode(), body, hashlib.sha256).hexdigest()
    return f"sha256={mac}"


def _is_private_ip(ip: str) -> bool:
    addr = ipaddress.ip_address(ip)
    return (addr.is_private or addr.is_loopback or addr.is_link_local
            or addr.is_reserved or addr.is_multicast)


def url_allowed(url: str, *, allow_private: bool | None = None) -> bool:
    """Static SSRF checks (reference webhook_service.py:143): https/http
    only, no credentials in the URL, no private IP literals. Hostname
    targets are vetted again *at connect time* by the delivery session's
    resolver (see :func:`make_session`) so DNS rebinding between check and
    send cannot redirect a delivery into a private network."""
    if allow_private is None:
        allow_private = config.WEBHOOK_ALLOW_PRIVATE
    try:
        parts = urlparse(url)
    except ValueError:
        return False
    if parts.scheme not in ("http", "https") or not parts.hostname:
        return False
    if parts.username or parts.password:
        return False
    if not allow_private:
        try:
            if _is_private_ip(parts.hostname):
                return False
        except ValueError:
            pass        # a hostname; the connect-time resolver vets it
    return True


class _VettingResolver(aiohttp.abc.AbstractResolver):
    """DNS resolver that refuses private answers at CONNECT time —
    closing the resolve-then-reresolve TOCTOU (DNS rebinding) that a
    one-shot pre-check leaves open."""

    def __init__(self) -> None:
        self._inner = aiohttp.DefaultResolver()

    async def resolve(self, host, port=0, family=0):
        infos = await self._inner.resolve(host, port, family)
        vetted = [i for i in infos if not _is_private_ip(i["host"])]
        if not vetted:
            raise OSError(f"webhook target {host} resolves only to "
                          "private addresses")
        return vetted

    async def close(self) -> None:
        await self._inner.close()


def make_session(*, allow_private: bool) -> aiohttp.ClientSession:
    connector = None
    if not allow_private:
        connector = aiohttp.TCPConnector(resolver=_VettingResolver())
    return aiohttp.ClientSession(
        connector=connector,
        timeout=aiohttp.ClientTimeout(total=DELIVERY_TIMEOUT_S))


async def trigger_event(db: Database, event: str, payload: dict) -> int:
    """Create delivery rows for every active endpoint subscribed to
    ``event`` (empty filter = all events). Returns rows created."""
    hooks = await db.fetch_all("SELECT * FROM webhooks WHERE active=1")
    t = db_now()
    body = {"event": event, "timestamp": t, "data": payload}
    n = 0
    for h in hooks:
        events = json.loads(h["events"] or "[]")
        if events and event not in events:
            continue
        await db.execute(
            """
            INSERT INTO webhook_deliveries (webhook_id, event, payload,
                                            status, next_attempt_at,
                                            created_at)
            VALUES (:w, :e, :p, 'pending', :t, :t)
            """,
            {"w": h["id"], "e": event, "p": json.dumps(body), "t": t})
        n += 1
    if n:
        from vlog_tpu_torch.jobs.events import CH_WEBHOOKS, wake

        wake(db, CH_WEBHOOKS, {"event": event})
    return n


def make_event_hook(db: Database):
    """An ``on_event`` async callable for the daemon / worker API."""

    async def hook(event: str, payload: dict) -> None:
        await trigger_event(db, event, payload)

    return hook


@dataclass
class DeliveryResult:
    delivered: int = 0
    retried: int = 0
    failed: int = 0


class WebhookDeliverer:
    """Drains pending deliveries. Multiple deliverer processes are safe:
    each row is claimed ('delivering' + a short lease) before the send, so
    the admin-hosted deliverer and a standalone one never double-post."""

    def __init__(self, db: Database, *, poll_interval_s: float = 5.0,
                 allow_private: bool | None = None):
        self.db = db
        self.poll_interval_s = poll_interval_s
        self.allow_private = (config.WEBHOOK_ALLOW_PRIVATE
                              if allow_private is None else allow_private)
        self._session: aiohttp.ClientSession | None = None
        self._stop = asyncio.Event()

    def request_stop(self) -> None:
        self._stop.set()

    async def _get_session(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = make_session(allow_private=self.allow_private)
        return self._session

    async def aclose(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    async def deliver_pending(self) -> DeliveryResult:
        """One drain pass over due deliveries."""
        t = db_now()
        # return crashed deliverers' stale in-flight claims to the pool
        await self.db.execute(
            """
            UPDATE webhook_deliveries SET status='pending'
            WHERE status='delivering' AND next_attempt_at <= :t
            """, {"t": t})
        rows = await self.db.fetch_all(
            """
            SELECT d.*, w.url, w.secret, w.active
            FROM webhook_deliveries d JOIN webhooks w ON w.id = d.webhook_id
            WHERE d.status = 'pending' AND d.next_attempt_at <= :t
            ORDER BY d.next_attempt_at LIMIT 50
            """, {"t": t})
        result = DeliveryResult()
        session = await self._get_session()
        for row in rows:
            claimed = await self.db.execute(
                """
                UPDATE webhook_deliveries
                SET status='delivering', next_attempt_at=:lease
                WHERE id=:id AND status='pending'
                """, {"lease": db_now() + INFLIGHT_LEASE_S, "id": row["id"]})
            if not claimed:      # another deliverer took it
                continue
            await self._deliver_one(session, row, result)
        return result

    async def _deliver_one(self, session: aiohttp.ClientSession, row: Row,
                           result: DeliveryResult) -> None:
        attempt = (row["attempts"] or 0) + 1
        if not row["active"] or not url_allowed(
                row["url"], allow_private=self.allow_private):
            await self._mark_failed(row, attempt, code=None,
                                    reason="target not allowed")
            result.failed += 1
            return
        body = row["payload"].encode()
        headers = {"Content-Type": "application/json",
                   "User-Agent": "vlog-tpu-webhooks/1.0",
                   "X-VLog-Event": row["event"]}
        if row["secret"]:
            headers[SIGNATURE_HEADER] = sign_payload(row["secret"], body)
        code = None
        try:
            async with session.post(row["url"], data=body, headers=headers,
                                    allow_redirects=False) as resp:
                code = resp.status
                ok = 200 <= code < 300
        except (aiohttp.ClientError, OSError, asyncio.TimeoutError) as exc:
            log.debug("webhook %s: %s", row["url"], exc)
            ok = False
        t = db_now()
        if ok:
            await self.db.execute(
                """
                UPDATE webhook_deliveries SET status='delivered',
                       attempts=:a, response_code=:c, delivered_at=:t
                WHERE id=:id
                """, {"a": attempt, "c": code, "t": t, "id": row["id"]})
            result.delivered += 1
        elif attempt >= MAX_DELIVERY_ATTEMPTS:
            await self._mark_failed(row, attempt, code=code,
                                    reason="attempts exhausted")
            result.failed += 1
        else:
            delay = BACKOFF_BASE_S * (2 ** (attempt - 1))
            await self.db.execute(
                """
                UPDATE webhook_deliveries SET status='pending', attempts=:a,
                       response_code=:c, next_attempt_at=:next
                WHERE id=:id
                """,
                {"a": attempt, "c": code, "next": t + delay, "id": row["id"]})
            result.retried += 1

    async def _mark_failed(self, row: Row, attempt: int, *, code,
                           reason: str) -> None:
        log.warning("webhook delivery %s failed permanently: %s",
                    row["id"], reason)
        await self.db.execute(
            """
            UPDATE webhook_deliveries SET status='failed', attempts=:a,
                   response_code=:c
            WHERE id=:id
            """, {"a": attempt, "c": code, "id": row["id"]})

    async def run(self) -> None:
        """Poll-and-drain until stopped (background task in the admin API,
        reference webhook_service.py:809-847). Old terminal rows are
        pruned roughly hourly so the table stays bounded."""
        from vlog_tpu_torch.jobs.events import CH_WEBHOOKS, bus_for

        bus = bus_for(self.db)
        await bus.start()
        sub = bus.subscribe(CH_WEBHOOKS)
        passes = 0
        cleanup_every = max(1, int(3600 / max(self.poll_interval_s, 0.1)))
        try:
            while not self._stop.is_set():
                sub.drain()   # the pass below covers anything queued;
                #               hints arriving DURING it stay queued and
                #               skip the sleep
                try:
                    await self.deliver_pending()
                    if passes % cleanup_every == 0:
                        await self.cleanup()
                except Exception:
                    log.exception("webhook drain pass failed")
                passes += 1
                await sub.wait_or(self._stop, self.poll_interval_s)
        finally:
            sub.close()
            await self.aclose()

    async def cleanup(self, *, keep_days: float = 30.0) -> int:
        """Prune old terminal rows (reference webhook_service.py:729-807)."""
        return await self.db.execute(
            """
            DELETE FROM webhook_deliveries
            WHERE status IN ('delivered', 'failed')
              AND created_at < :cut
            """, {"cut": db_now() - keep_days * 86400})


async def _amain() -> None:
    from vlog_tpu_torch.db.schema import create_all

    db = open_database(config.DATABASE_URL)
    await db.connect()
    await create_all(db)
    deliverer = WebhookDeliverer(db)
    log.info("webhook deliverer running")
    try:
        await deliverer.run()
    finally:
        await db.disconnect()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    asyncio.run(_amain())
