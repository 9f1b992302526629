"""Disk-backed L2 below the delivery plane's RAM LRU (a copy of
``vlog_tpu/delivery/l2.py``: the same filenames, so either package reads
the other's store).

A content-addressed spill store: entries land here on L1 eviction and on
fill, named by their publish-manifest sha256 (``<digest[:2]>/<digest>``),
and byte-bounded with LRU eviction of its own. Because the name *is* the
digest, lookups are exact-content by construction — a republished
segment gets a new digest and simply stops being looked up, so slug
invalidation never has to touch the L2 at all; stale objects age out.

Trust model: the store is a cache on local disk, not a source of truth.
Every read hashes the bytes and compares against the digest name before
anything can serve or promote to L1 — a corrupt or truncated entry is
deleted and reported so the caller refills from the origin tree (or a
peer), never served.

Thread model: fills and spills run on ``asyncio.to_thread`` workers
while stats are read from the event loop, so the index is lock-guarded.
File reads/writes happen OUTSIDE the lock (only index bookkeeping is
serialized); the worst interleaving is two threads verifying the same
digest twice, which is idempotent.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Callable

log = logging.getLogger("vlog.delivery.l2")

__all__ = ["DiskL2"]

# sha256 hex: the only filenames the store creates or trusts on rescan.
_DIGEST_LEN = 64
_TMP_PREFIX = "tmp-"


def _is_digest(name: str) -> bool:
    if len(name) != _DIGEST_LEN:
        return False
    try:
        int(name, 16)
    except ValueError:
        return False
    return True


class DiskL2:
    """Byte-bounded digest-named disk store with LRU eviction.

    Optionally popularity-aware: callers may stamp each ``put`` with the
    owning slug's *heat* (the plane's exponentially-decayed per-slug
    request rate). With ``admit_heat`` set, bodies below the threshold
    bypass the spill entirely (a one-hit-wonder should not push a
    herd-warmed segment off disk); with ``hot_heat`` set, the eviction
    sweep gives entries at or above it a bounded second chance — their
    heat halves and they move to the MRU end, so colder bytes go first.
    Both default to 0 (off): pure LRU, the pre-fabric behavior.
    """

    def __init__(self, root: str | Path, max_bytes: int, *,
                 on_evict: Callable[[int], None] | None = None,
                 on_rescue: Callable[[int], None] | None = None,
                 admit_heat: float = 0.0,
                 hot_heat: float = 0.0) -> None:
        self.root = Path(root)
        self.max_bytes = int(max_bytes)
        self._on_evict = on_evict
        self._on_rescue = on_rescue
        self.admit_heat = float(admit_heat)
        self.hot_heat = float(hot_heat)
        self._lock = threading.Lock()             # lock-order: 54
        # guarded-by: _lock
        self._index: OrderedDict[str, int] = OrderedDict()  # digest -> size
        # guarded-by: _lock
        self._heat: dict[str, float] = {}   # digest -> heat at last put
        # guarded-by: _lock
        self._bytes = 0
        # guarded-by: _lock
        self.counters = {
            "hits": 0, "misses": 0, "corrupt": 0,
            "stores": 0, "evictions": 0,
            "rescues": 0, "admit_skips": 0,
        }
        if self.enabled:
            self.root.mkdir(parents=True, exist_ok=True)
            self._rescan()

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    # -- init-time rescan --------------------------------------------------

    def _rescan(self) -> None:
        """Rebuild the index from disk so the warm set survives process
        restarts. Ordered oldest-mtime-first (approximate recency: mtimes
        mirror the origin segment, not last access), then trimmed to
        budget. Stray temp files from a crashed writer are swept."""
        found: list[tuple[float, str, int]] = []
        for shard in sorted(self.root.iterdir()) if self.root.is_dir() else []:
            if not shard.is_dir():
                if shard.name.startswith(_TMP_PREFIX):
                    shard.unlink(missing_ok=True)
                continue
            for f in shard.iterdir():
                if f.name.startswith(_TMP_PREFIX):
                    f.unlink(missing_ok=True)
                    continue
                if not _is_digest(f.name):
                    continue
                try:
                    st = f.stat()
                except OSError:
                    continue
                found.append((st.st_mtime, f.name, st.st_size))
        found.sort()
        with self._lock:
            for _, digest, size in found:
                self._index[digest] = size
                self._bytes += size
            victims = self._evict_over_budget_locked()
        self._unlink_all(victims)

    # -- core --------------------------------------------------------------

    def path_for(self, digest: str) -> Path:
        return self.root / digest[:2] / digest

    def read(self, digest: str) -> tuple[str, bytes | None, float]:
        """``(outcome, body, mtime)`` — outcome one of hit/miss/corrupt.

        A hit returns the verified bytes plus the stored mtime (the
        origin segment's, preserved at store time so Last-Modified is
        identical whichever tier serves). corrupt means the bytes were
        there but failed the digest check; the entry has already been
        deleted and the caller must refill from origin.
        """
        if not self.enabled:
            return "miss", None, 0.0
        with self._lock:
            if digest in self._index:
                self._index.move_to_end(digest)
                known = True
            else:
                known = False
        path = self.path_for(digest)
        if not known:
            self._bump("misses")
            return "miss", None, 0.0
        try:
            st = path.stat()
            body = path.read_bytes()
        except OSError:
            # indexed but unreadable (crash residue, external wipe)
            self._drop(digest)
            self._bump("misses")
            return "miss", None, 0.0
        if hashlib.sha256(body).hexdigest() != digest:
            log.warning("l2 entry %s failed digest check (%d bytes); "
                        "deleting", digest[:12], len(body))
            self._drop(digest)
            path.unlink(missing_ok=True)
            self._bump("corrupt")
            return "corrupt", None, 0.0
        self._bump("hits")
        return "hit", body, st.st_mtime

    def put(self, digest: str, body: bytes, mtime: float, *,
            heat: float = 0.0) -> bool:
        """Store verified bytes under their digest; no-op when already
        present, when the object alone exceeds the byte budget, or when
        ``admit_heat`` is set and the slug's heat falls below it.
        Atomic: temp write + rename, so readers never see a torn file."""
        if not self.enabled or len(body) > self.max_bytes:
            return False
        if self.admit_heat > 0.0 and heat < self.admit_heat:
            self._bump("admit_skips")
            return False
        with self._lock:
            if digest in self._index:
                self._index.move_to_end(digest)
                self._heat[digest] = max(self._heat.get(digest, 0.0), heat)
                return False
        path = self.path_for(digest)
        tmp = path.parent / f"{_TMP_PREFIX}{digest[:16]}-{os.getpid()}"
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp.write_bytes(body)
            # carry the origin segment's mtime so Last-Modified (and the
            # If-Range date match) is identical across L1/L2/sendfile
            os.utime(tmp, (mtime, mtime))
            os.replace(tmp, path)
        except OSError as exc:
            log.warning("l2 store failed for %s: %s", digest[:12], exc)
            tmp.unlink(missing_ok=True)
            return False
        with self._lock:
            if digest in self._index:       # racing writer beat us
                self._index.move_to_end(digest)
                self._heat[digest] = max(self._heat.get(digest, 0.0), heat)
                return False
            self._index[digest] = len(body)
            self._heat[digest] = heat
            self._bytes += len(body)
            self.counters["stores"] += 1
            victims = self._evict_over_budget_locked()
        self._unlink_all(victims)
        return True

    def _evict_over_budget_locked(self) -> list[str]:
        """LRU-evict index entries until under budget; returns the digests
        whose files the caller must unlink (outside the lock).

        With ``hot_heat`` set, an LRU-front entry at or above it gets a
        second chance instead: its heat halves and it moves to the MRU
        end. Rescues are bounded to one per entry per sweep (and the
        halving converges regardless), so the sweep always terminates.
        """
        victims: list[str] = []
        rescues_left = len(self._index) if self.hot_heat > 0.0 else 0
        while self._bytes > self.max_bytes and self._index:
            digest, size = self._index.popitem(last=False)
            heat = self._heat.get(digest, 0.0)
            if rescues_left > 0 and heat >= self.hot_heat:
                rescues_left -= 1
                self._heat[digest] = heat / 2.0
                self._index[digest] = size      # reinsert at MRU end
                self.counters["rescues"] += 1
                if self._on_rescue is not None:
                    self._on_rescue(1)
                continue
            self._heat.pop(digest, None)
            self._bytes -= size
            self.counters["evictions"] += 1
            victims.append(digest)
        return victims

    def _unlink_all(self, digests: list[str]) -> None:
        for digest in digests:
            self.path_for(digest).unlink(missing_ok=True)
            if self._on_evict is not None:
                self._on_evict(1)

    def _drop(self, digest: str) -> None:
        with self._lock:
            size = self._index.pop(digest, None)
            self._heat.pop(digest, None)
            if size is not None:
                self._bytes -= size

    def _bump(self, key: str) -> None:
        with self._lock:
            self.counters[key] += 1

    def clear(self) -> int:
        """Drop every entry (admin invalidate-all); returns count.
        Not counted as evictions — a clear is an operator action, not
        budget pressure."""
        with self._lock:
            victims = list(self._index)
            self._index.clear()
            self._heat.clear()
            self._bytes = 0
        for digest in victims:
            self.path_for(digest).unlink(missing_ok=True)
        return len(victims)

    def stats(self) -> dict:
        with self._lock:
            return {
                "bytes": self._bytes,
                "budget_bytes": self.max_bytes,
                "entries": len(self._index),
                **self.counters,
            }
