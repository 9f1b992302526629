"""Orphan GC: every byte of scratch space is reclaimable (a copy of
``vlog_tpu/storage/gc.py``).

Four leak classes accumulate on a long-lived deployment, none of which
any request path cleans up:

- ``.part`` / ``.tmp`` temps under the video tree — a worker that died
  mid-upload leaves its partial behind forever.
- ``.upload-*`` staging files under the upload dir — an admin upload
  whose connection dropped between the size cap and the probe.
- Output trees of soft-deleted videos — ``DELETE /api/videos/{id}`` is
  restorable, so the tree must survive a grace window, but after
  ``VLOG_GC_DELETED_RETENTION`` it is dead weight at ladder scale.
- Abandoned worker job workspaces — a remote worker's
  ``work_dir/{slug}`` scratch when the process was SIGKILLed between
  claim and its own ``rmtree``. Remote workers have no DB access, so
  they sweep their own scratch via :func:`sweep_worker_workspaces`
  (startup + on entering disk-pressure pause); the age threshold keeps
  recent workspaces, which are resume assets for a reclaimed job.

The sweeper is age-thresholded (``VLOG_GC_TEMP_MAX_AGE`` — a *young*
temp may be an in-flight upload), dry-runnable, and hard-gated on live
claims: nothing under a slug with an actively claimed job is ever
touched, whatever its age — the claim holder owns that tree. Reports
and cumulative totals feed the admin trigger/report endpoint and the
``storage`` tab; the ``storage.gc`` failpoint aborts a sweep for chaos
runs.
"""

from __future__ import annotations

import asyncio
import logging
import shutil
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

from vlog_tpu_torch import config
from vlog_tpu_torch.db.core import Database, now as db_now
from vlog_tpu_torch.enums import GCTarget
from vlog_tpu_torch.jobs import state as js
from vlog_tpu_torch.storage import integrity
from vlog_tpu_torch.utils import failpoints

log = logging.getLogger("vlog_tpu_torch.storage.gc")


@dataclass
class GCReport:
    """One sweep's findings; ``removed`` entries are
    ``{path, kind, bytes}`` (kind: enums.GCTarget value)."""

    dry_run: bool = False
    started_at: float = 0.0
    duration_s: float = 0.0
    scanned: int = 0
    removed: list[dict] = field(default_factory=list)
    kept_live: list[str] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)

    @property
    def bytes_reclaimed(self) -> int:
        return sum(e["bytes"] for e in self.removed)

    def to_dict(self) -> dict:
        return {
            "dry_run": self.dry_run,
            "started_at": self.started_at,
            "duration_s": round(self.duration_s, 3),
            "scanned": self.scanned,
            "removed": self.removed,
            "removed_count": len(self.removed),
            "bytes_reclaimed": self.bytes_reclaimed,
            "kept_live": self.kept_live,
            "errors": self.errors,
        }


class GCBusyError(RuntimeError):
    """A sweep is already in progress in this process."""


# Cumulative process totals + last report for the admin report endpoint
# (worker-API-style observability without a second Prometheus registry).
_totals_lock = threading.Lock()
# Serializes whole-tree sweeps: the hourly loop and the admin trigger
# racing each other would double-count reclaimed bytes and turn the
# loser's rmtree of an already-deleted dir into spurious report errors.
# threading (not asyncio) so it holds across event loops in one process.
_run_lock = threading.Lock()
TOTALS = {"runs": 0, "files_removed": 0, "bytes_reclaimed": 0, "errors": 0}
LAST_REPORT: GCReport | None = None


def _tree_size(path: Path) -> int:
    total = 0
    try:
        if path.is_file():
            return path.stat().st_size
        for p in path.rglob("*"):
            if p.is_file():
                total += p.stat().st_size
    except OSError:
        pass
    return total


def _mtime(path: Path) -> float:
    try:
        return path.stat().st_mtime
    except OSError:
        return 0.0


class _Sweep:
    """One sweep's mutable state; the filesystem walk runs synchronously
    (callers thread it via run_gc)."""

    def __init__(self, report: GCReport, *, dry_run: bool):
        self.report = report
        self.dry_run = dry_run

    def remove(self, path: Path, kind: GCTarget) -> None:
        size = _tree_size(path)
        if not self.dry_run:
            try:
                if path.is_dir():
                    shutil.rmtree(path)
                else:
                    path.unlink(missing_ok=True)
            except OSError as exc:
                self.report.errors.append(f"{path}: {exc}")
                return
        self.report.removed.append(
            {"path": str(path), "kind": kind.value, "bytes": size})

    def sweep_video_dir(self, video_dir: Path, *, live: set[str],
                        known: set[str], deleted_due: set[str],
                        temp_cut: float, orphan_cut: float) -> None:
        if not video_dir.is_dir():
            return
        for entry in sorted(video_dir.iterdir()):
            self.report.scanned += 1
            slug = entry.name
            if slug in live:
                # An actively claimed job owns this tree — even its
                # .part files may be in-flight uploads. Never touch.
                self.report.kept_live.append(str(entry))
                continue
            if entry.is_dir():
                if slug in deleted_due:
                    self.remove(entry, GCTarget.DELETED_TREE)
                    continue
                if slug not in known and _mtime(entry) <= orphan_cut:
                    # Whole-tree reclamation uses the LONG retention
                    # (an unknown tree may be a slug whose DB row was
                    # lost to a restore, or an operator's directory),
                    # not the in-flight-temp age.
                    self.remove(entry, GCTarget.ORPHAN_TREE)
                    continue
                self._sweep_temps(entry, temp_cut)
            elif integrity._is_temp(slug) and _mtime(entry) <= temp_cut:
                self.remove(entry, GCTarget.PART_FILE)

    def _sweep_temps(self, tree: Path, temp_cut: float) -> None:
        """Stale temps inside a tree that otherwise stays."""
        try:
            candidates = sorted(tree.rglob("*"))
        except OSError as exc:
            self.report.errors.append(f"{tree}: {exc}")
            return
        for p in candidates:
            if not p.is_file() or not integrity._is_temp(p.name):
                continue
            self.report.scanned += 1
            if _mtime(p) <= temp_cut:
                self.remove(p, GCTarget.PART_FILE)

    def sweep_upload_dir(self, upload_dir: Path, *, temp_cut: float) -> None:
        # ONLY the .upload-* staging prefix: that namespace is ours by
        # construction (admin_api upload_video). A permanent source can
        # legitimately end in .part/.tmp — upload_video preserves the
        # original extension — so suffix matching here would eat it.
        if not upload_dir.is_dir():
            return
        for p in sorted(upload_dir.iterdir()):
            if not p.is_file():
                continue
            if p.name.startswith(integrity.UPLOAD_TEMP_PREFIX):
                self.report.scanned += 1
                if _mtime(p) <= temp_cut:
                    self.remove(p, GCTarget.UPLOAD_TEMP)

    def sweep_workspaces(self, work_dir: Path, *, live: set[str],
                         temp_cut: float) -> None:
        """Abandoned remote-worker job workspaces (work_dir/{slug})."""
        if not work_dir.is_dir():
            return
        for entry in sorted(work_dir.iterdir()):
            if not entry.is_dir():
                continue
            self.report.scanned += 1
            if entry.name in live:
                self.report.kept_live.append(str(entry))
                continue
            if _mtime(entry) <= temp_cut:
                self.remove(entry, GCTarget.WORKSPACE)


async def _slug_sets(db: Database, *, deleted_retention_s: float,
                     now: float) -> tuple[set[str], set[str], set[str]]:
    """(live-claim slugs, all known slugs, deletion-due slugs)."""
    live_rows = await db.fetch_all(
        f"""
        SELECT DISTINCT v.slug FROM jobs j JOIN videos v ON v.id = j.video_id
        WHERE {js.SQL_ACTIVELY_CLAIMED}
        """, {"now": db_now()})
    rows = await db.fetch_all("SELECT slug, deleted_at FROM videos")
    live = {r["slug"] for r in live_rows}
    known = {r["slug"] for r in rows}
    deleted_due = {r["slug"] for r in rows
                   if r["deleted_at"] is not None
                   and r["deleted_at"] <= now - deleted_retention_s}
    return live, known, deleted_due


async def run_gc(
    db: Database,
    *,
    video_dir: str | Path | None = None,
    upload_dir: str | Path | None = None,
    work_dirs: tuple[str | Path, ...] = (),
    temp_max_age_s: float | None = None,
    deleted_retention_s: float | None = None,
    dry_run: bool = False,
    now: float | None = None,
) -> GCReport:
    """One full sweep; returns (and records) the report.

    The DB reads run on the event loop; the filesystem walk runs in a
    thread. ``now`` is injectable for tests.
    """
    failpoints.hit("storage.gc")
    if not _run_lock.acquire(blocking=False):
        raise GCBusyError("a gc sweep is already running")
    try:
        t0 = time.monotonic()
        now = time.time() if now is None else now
        temp_age = (config.GC_TEMP_MAX_AGE_S if temp_max_age_s is None
                    else temp_max_age_s)
        retention = (config.GC_DELETED_RETENTION_S
                     if deleted_retention_s is None else deleted_retention_s)
        report = GCReport(dry_run=dry_run, started_at=now)
        live, known, deleted_due = await _slug_sets(
            db, deleted_retention_s=retention, now=now)
        temp_cut = now - temp_age
        sweep = _Sweep(report, dry_run=dry_run)

        def walk() -> None:
            if video_dir is not None:
                sweep.sweep_video_dir(Path(video_dir), live=live,
                                      known=known, deleted_due=deleted_due,
                                      temp_cut=temp_cut,
                                      orphan_cut=now - retention)
            if upload_dir is not None:
                sweep.sweep_upload_dir(Path(upload_dir), temp_cut=temp_cut)
            for wd in work_dirs:
                sweep.sweep_workspaces(Path(wd), live=live,
                                       temp_cut=temp_cut)

        await asyncio.to_thread(walk)
        report.duration_s = time.monotonic() - t0
    finally:
        _run_lock.release()
    _record(report)
    return report


def _record(report: GCReport) -> None:
    global LAST_REPORT
    with _totals_lock:
        LAST_REPORT = report
        TOTALS["runs"] += 1
        if not report.dry_run:
            TOTALS["files_removed"] += len(report.removed)
            TOTALS["bytes_reclaimed"] += report.bytes_reclaimed
        TOTALS["errors"] += len(report.errors)
    # mirror the totals into the process metrics registry so GC health
    # is scrapeable, not just visible in the admin report endpoint
    from vlog_tpu_torch.obs.metrics import runtime

    m = runtime()
    m.gc_runs.inc()
    if not report.dry_run:
        m.gc_files_removed.inc(len(report.removed))
        m.gc_bytes_reclaimed.inc(report.bytes_reclaimed)
    m.gc_errors.inc(len(report.errors))
    if report.removed or report.errors:
        log.info("gc%s: removed=%d bytes=%d errors=%d",
                 " (dry-run)" if report.dry_run else "",
                 len(report.removed), report.bytes_reclaimed,
                 len(report.errors))


def sweep_worker_workspaces(
    work_dir: str | Path,
    *,
    live: frozenset[str] | set[str] = frozenset(),
    temp_max_age_s: float | None = None,
    dry_run: bool = False,
    now: float | None = None,
) -> GCReport:
    """Workspace-only sweep of a worker's own scratch dir (synchronous;
    callers thread it). Remote workers cannot reach the DB, but they
    don't need to: between jobs nothing in ``work_dir`` is live, and
    the age threshold protects fresh workspaces a reclaimed job could
    still resume onto (claim leases are minutes; the default threshold
    is hours)."""
    t0 = time.monotonic()
    now = time.time() if now is None else now
    age = (config.GC_TEMP_MAX_AGE_S if temp_max_age_s is None
           else temp_max_age_s)
    report = GCReport(dry_run=dry_run, started_at=now)
    sweep = _Sweep(report, dry_run=dry_run)
    sweep.sweep_workspaces(Path(work_dir), live=set(live),
                           temp_cut=now - age)
    report.duration_s = time.monotonic() - t0
    _record(report)
    return report


def snapshot() -> dict:
    """Last report + cumulative totals (admin report endpoint)."""
    with _totals_lock:
        return {
            "totals": dict(TOTALS),
            "last_report": (None if LAST_REPORT is None
                            else LAST_REPORT.to_dict()),
        }
