"""Byte-bounded LRU segment cache + single-flight miss collapsing (a copy
of ``vlog_tpu/delivery/cache.py``).

The data structures under the delivery plane (delivery/plane.py). Both
are event-loop-confined: the public API process owns one instance of
each and every touch happens on its loop, so there is no locking —
what bounds concurrency is the admission semaphore in the plane, not
these containers.

- :class:`SegmentCache` — an ``OrderedDict`` LRU over
  :class:`CacheEntry` values, bounded by TOTAL BODY BYTES (not entry
  count — a 2160p init segment and a 96-byte VTT cue are not the same
  cost). Lookup is by ``(slug, rel)``; the content *version*
  (manifest sha256, or mtime when no manifest covers the file) lives on
  the entry and becomes its ETag, so a republished tree yields a new
  ETag the moment the old entry is invalidated or expires.
- :class:`SingleFlight` — collapses N concurrent misses for one key
  onto a single fill: the first caller starts the factory in a
  detached task, everyone (including that caller) awaits it shielded,
  so a disconnecting client cancels only its own wait, never the
  shared fill. A failed fill propagates the error to every waiter and
  leaves NOTHING behind — the next request simply starts a new fill,
  so transient read errors cannot poison a key.
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from typing import Awaitable, Callable

Key = tuple[str, str]          # (slug, rel)


class CacheEntry:
    """One cached media object: body bytes + the response metadata."""

    __slots__ = ("slug", "rel", "version", "body", "etag", "mime",
                 "mtime", "immutable", "expires_at", "digest")

    def __init__(self, *, slug: str, rel: str, version: str, body: bytes,
                 etag: str, mime: str, mtime: float, immutable: bool,
                 expires_at: float | None = None,
                 digest: str | None = None):
        self.slug = slug
        self.rel = rel
        self.version = version      # manifest sha256 or mtime-ns tag
        self.body = body
        self.etag = etag            # strong ETag, quotes included
        self.mime = mime
        self.mtime = mtime          # seconds; Last-Modified / If-Range
        self.immutable = immutable  # segments: yes; .m3u8/.mpd: no
        self.expires_at = expires_at  # monotonic deadline; None = pinned
        self.digest = digest        # manifest sha256 when covered: the
        #                             L2 spill key; None = L2-ineligible

    @property
    def size(self) -> int:
        return len(self.body)

    def fresh(self, now: float) -> bool:
        return self.expires_at is None or now < self.expires_at


class FileEntry:
    """A file-backed media object served zero-copy via ``os.sendfile``:
    the ``> VLOG_DELIVERY_MAX_ENTRY_BYTES`` bypass and L2 hits at or
    above ``VLOG_DELIVERY_SENDFILE_BYTES``. Carries the same response
    metadata (validators included) as :class:`CacheEntry` but no body —
    it is never retained in the RAM LRU, and ``delivery/http.py`` builds
    its 200/206 from the file instead of a buffer."""

    __slots__ = ("slug", "rel", "path", "size", "etag", "mime", "mtime",
                 "immutable", "digest")

    def __init__(self, *, slug: str, rel: str, path, size: int, etag: str,
                 mime: str, mtime: float, immutable: bool,
                 digest: str | None = None):
        self.slug = slug
        self.rel = rel
        self.path = path
        self.size = size
        self.etag = etag
        self.mime = mime
        self.mtime = mtime
        self.immutable = immutable
        self.digest = digest


class SegmentCache:
    """LRU over ``(slug, rel)`` bounded by total body bytes."""

    def __init__(self, max_bytes: int, *,
                 on_evict: Callable[[CacheEntry], None] | None = None):
        self.max_bytes = max_bytes
        self._entries: OrderedDict[Key, CacheEntry] = OrderedDict()
        self._bytes = 0
        self._on_evict = on_evict
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.expirations = 0

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def bytes_cached(self) -> int:
        return self._bytes

    def get(self, key: Key, *, now: float | None = None) -> CacheEntry | None:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        if not entry.fresh(time.monotonic() if now is None else now):
            self._drop(key)
            self.expirations += 1
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def put(self, entry: CacheEntry) -> bool:
        """Insert (replacing any same-key entry), evicting LRU entries
        until the budget holds. Returns False — and caches nothing —
        when the body alone exceeds the whole budget."""
        if self.max_bytes <= 0 or entry.size > self.max_bytes:
            return False
        key = (entry.slug, entry.rel)
        self._drop(key)
        self._entries[key] = entry
        self._bytes += entry.size
        while self._bytes > self.max_bytes and self._entries:
            _, victim = self._entries.popitem(last=False)
            self._bytes -= victim.size
            self.evictions += 1
            if self._on_evict is not None:
                # the whole entry, not just its size: the delivery
                # plane's hook spills digest-covered victims to the L2
                self._on_evict(victim)
        return True

    def invalidate_slug(self, slug: str) -> int:
        """Drop every entry under one slug; returns entries dropped."""
        doomed = [k for k in self._entries if k[0] == slug]
        for k in doomed:
            self._drop(k)
        return len(doomed)

    def clear(self) -> int:
        n = len(self._entries)
        self._entries.clear()
        self._bytes = 0
        return n

    def _drop(self, key: Key) -> None:
        entry = self._entries.pop(key, None)
        if entry is not None:
            self._bytes -= entry.size


class SingleFlight:
    """Collapse concurrent async fills of one key onto a single run."""

    def __init__(self, *, on_collapse: Callable[[], None] | None = None):
        self._inflight: dict[Key, asyncio.Task] = {}
        self._on_collapse = on_collapse
        self.collapses = 0      # followers who rode a leader's fill

    def inflight(self) -> int:
        return len(self._inflight)

    def pending(self, key: Key) -> bool:
        """Whether a fill for ``key`` is in flight right now — a caller
        about to ``run`` this key would collapse onto it."""
        return key in self._inflight

    async def run(self, key: Key, factory: Callable[[], Awaitable]):
        task = self._inflight.get(key)
        if task is not None:
            self.collapses += 1
            if self._on_collapse is not None:
                self._on_collapse()
        else:
            # The fill runs in its OWN task, not inline in the leader's
            # handler: a leader whose client disconnects gets cancelled
            # by aiohttp, and an inline fill would propagate that
            # CancelledError to every follower still connected.
            task = asyncio.get_running_loop().create_task(
                factory(), name="vlog-cache-fill")
            task.add_done_callback(self._retire(key))
            self._inflight[key] = task
        # shield: cancelling one waiter must not cancel the shared fill
        return await asyncio.shield(task)

    def _retire(self, key: Key) -> Callable[[asyncio.Task], None]:
        def done(task: asyncio.Task) -> None:
            self._inflight.pop(key, None)
            if not task.cancelled():
                task.exception()    # mark retrieved: all-waiters-gone case
        return done
