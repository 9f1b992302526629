"""playback_sessions lifecycle maintenance: monthly buckets, bounded
pruning, per-month stats (a copy of ``vlog_tpu/jobs/sessions.py``).

Reference analog: api/partition_manager.py (302 LoC) — the reference
attaches monthly PG partitions to playback_sessions so analytics scans
stay fast and old months drop in O(1). This schema runs on sqlite AND
Postgres through one facade, so the analog is bucket-wise maintenance
over the same ``started_at`` axis the partitions would use:

- :func:`prune_sessions` deletes rows past retention in bounded batches
  (one month at a time, capped rows per statement) so the write lock is
  never held for a table scan — the operational property partition
  DROPs buy the reference;
- :func:`month_stats` reports per-month row counts and watch time (the
  reference's get_partition_stats analog);
- :func:`close_stale_sessions` finalizes sessions whose heartbeat died
  (crash/tab-close), so "active viewers" cannot grow monotonically.

Wired into the admin API's background maintenance task next to webhook
delivery; the prune cadence is daily.
"""

from __future__ import annotations

import logging
import time
from datetime import datetime, timezone

from vlog_tpu_torch.db.core import Database, now as db_now

log = logging.getLogger("vlog.sessions")

RETENTION_DAYS = 365.0
STALE_HEARTBEAT_S = 300.0
_BATCH_ROWS = 5000


def month_bounds(year: int, month: int) -> tuple[float, float]:
    """[start, end) epoch seconds of a UTC calendar month."""
    if not 2000 <= year <= 2100 or not 1 <= month <= 12:
        raise ValueError(f"bad month {year}-{month}")
    start = datetime(year, month, 1, tzinfo=timezone.utc).timestamp()
    ny, nm = (year + 1, 1) if month == 12 else (year, month + 1)
    end = datetime(ny, nm, 1, tzinfo=timezone.utc).timestamp()
    return start, end


async def close_stale_sessions(db: Database,
                               stale_s: float = STALE_HEARTBEAT_S) -> int:
    """End sessions whose heartbeat stopped (reference: sessions just
    stop heartbeating on tab close; ended_at is set server-side)."""
    t = db_now()
    n = await db.execute(
        """
        UPDATE playback_sessions SET ended_at = last_heartbeat_at
        WHERE ended_at IS NULL AND last_heartbeat_at < :cut
        """, {"cut": t - stale_s})
    if n:
        log.info("closed %d stale playback sessions", n)
    return n


async def prune_sessions(db: Database,
                         retention_days: float = RETENTION_DAYS) -> int:
    """Delete sessions older than retention, oldest month first, in
    bounded batches. Returns rows deleted. Safe to call on any cadence:
    each statement touches at most _BATCH_ROWS rows of one month, so
    writers are never starved behind a long delete."""
    cutoff = db_now() - retention_days * 86400.0
    total = 0
    while True:
        oldest = await db.fetch_val(
            "SELECT MIN(started_at) FROM playback_sessions "
            "WHERE started_at < :cut", {"cut": cutoff})
        if oldest is None:
            break
        dt = datetime.fromtimestamp(float(oldest), tz=timezone.utc)
        lo, hi = month_bounds(dt.year, dt.month)
        hi = min(hi, cutoff)
        n = await db.execute(
            """
            DELETE FROM playback_sessions WHERE id IN (
                SELECT id FROM playback_sessions
                WHERE started_at >= :lo AND started_at < :hi
                LIMIT :cap
            )
            """, {"lo": lo, "hi": hi, "cap": _BATCH_ROWS})
        total += n
        if n == 0:
            # numeric edge: MIN() said rows exist but the bucket query
            # found none — bail rather than loop forever
            log.warning("session prune made no progress at %s", dt)
            break
    if total:
        log.info("pruned %d playback sessions past %.0f-day retention",
                 total, retention_days)
    return total


async def month_stats(db: Database, months: int = 12) -> list[dict]:
    """Per-month session counts + watch time, newest first (analog of
    the reference's get_partition_stats)."""
    t = time.gmtime(db_now())
    year, month = t.tm_year, t.tm_mon
    out = []
    for _ in range(months):
        lo, hi = month_bounds(year, month)
        row = await db.fetch_one(
            """
            SELECT COUNT(*) AS sessions,
                   COALESCE(SUM(watch_time_s), 0) AS watch_time_s
            FROM playback_sessions
            WHERE started_at >= :lo AND started_at < :hi
            """, {"lo": lo, "hi": hi})
        out.append({
            "month": f"{year:04d}-{month:02d}",
            "sessions": int(row["sessions"] or 0),
            "watch_time_s": float(row["watch_time_s"] or 0.0),
        })
        year, month = (year - 1, 12) if month == 1 else (year, month - 1)
    return out
