"""The delivery plane: origin-side caching + admission for serve_media
(a copy of ``vlog_tpu/delivery/plane.py``).

Sits between the public API's media route and the filesystem/DB so that
steady-state playback — every 4-second ``.m4s`` of every concurrent
viewer — touches neither Postgres nor ``open()``:

- a **publish-state cache** (slug -> ready/deleted/missing, TTL +
  explicit invalidation) answers the "may this slug serve at all?"
  gate from memory, via the narrow ``get_video_serving_state`` query on
  miss instead of the old ``SELECT * FROM videos`` per segment;
- the **segment cache** (delivery/cache.py) holds response buffers
  under a byte budget, ETags seeded from the ``outputs.json``
  manifest so revalidation compares the real published sha256;
- **single-flight** collapses N concurrent misses for one segment onto
  one disk read;
- an **admission bound** sheds distinct-key misses past
  ``VLOG_DELIVERY_MAX_INFLIGHT_READS`` with 503 + ``Retry-After``
  rather than queueing unbounded reads on the volume;
- **invalidation** — publish/re-encode/delete/restore/verify paths call
  :func:`invalidate_slug`, which fans out to every plane registered in
  this process (plus ``POST /api/delivery/invalidate`` for operators).

Below and beside the RAM LRU sits the **distributed tier**:

- a **disk-backed L2** (delivery/l2.py): digest-covered entries spill
  there on fill and on L1 eviction; an L1 miss probes it before any
  origin read, and every L2 read is sha256-verified against the
  manifest digest before it can serve — corrupt spills are deleted and
  refilled, never served. Content addressing makes slug invalidation a
  no-op for the L2: a republished file gets a new digest and the old
  object simply stops being looked up.
- a **rendezvous-hash ring** (delivery/ring.py) over
  ``VLOG_DELIVERY_PEERS``: a miss on a non-owner origin fetches the
  object from its owner over the public media route (digest-verified,
  loop-guarded by the ``X-Vlog-Peer-Fill`` header) before falling back
  to local disk, so the fleet converges on one hot set instead of N.
  A failing peer gets a short cooldown and fills degrade to local.

On top of the static ring sits the **self-healing fabric**:

- **gossip membership** (delivery/gossip.py): the peer set is seeded
  from ``VLOG_DELIVERY_PEERS`` but no longer frozen by it — jittered
  heartbeat probes walk each peer through alive -> suspect -> down ->
  rejoin, the ring rebuilds from the live view on every version bump,
  and a digest-liar peer is quarantined out of ownership entirely;
- **hedged fills**: a miss routed to the owner launches a hedge to the
  next-ranked healthy peer once the primary overruns the hedge budget
  (``VLOG_DELIVERY_HEDGE_MS``, p95-adaptive from the fill-latency
  reservoir); the first digest-valid response wins, the loser is
  cancelled before it can cache anything;
- **coalesced fills**: peer fetches carry a fill-token header
  (``X-Vlog-Fill-Token``); a tokened request landing on an origin with
  the same object's fill already in flight collapses onto it, so a
  fleet-wide flash crowd produces one origin disk read;
- **failure classification**: peer-fill failures split into transport /
  timeout / status / digest. Only transport and timeout feed gossip
  suspicion; a 503 shed honors the peer's own ``Retry-After`` as the
  cooldown; a digest mismatch quarantines the liar;
- **popularity-aware L2**: per-slug exponentially-decayed heat gates
  disk-L2 admission and grants hot entries second-chance eviction
  (delivery/l2.py), so a herd-warmed working set survives the crowd.
- **publish-time prewarm**: ``finalize_ready`` schedules
  :meth:`DeliveryPlane.prewarm_slug`, pulling every init segment plus
  the first ``VLOG_DELIVERY_PREWARM_SEGMENTS`` media segments of each
  rung through the normal fetch path so a fresh publish's first viewer
  hits RAM.
- a **zero-copy path**: the ``> VLOG_DELIVERY_MAX_ENTRY_BYTES`` bypass
  and L2 hits at or above ``VLOG_DELIVERY_SENDFILE_BYTES`` return
  :class:`~vlog_tpu_torch.delivery.cache.FileEntry`, which
  ``delivery/http.py`` serves via ``os.sendfile`` instead of buffering.

Counters go two places on purpose: the lock-guarded dict on the plane
(the admin stats panel and tests read exact deltas) and the
process-wide ``obs.metrics.runtime()`` registry (Prometheus families
``vlog_delivery_*`` — scraped via the public API's ``/metrics``).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import stat as stat_mod
import threading
import time
import weakref
from collections import deque
from dataclasses import dataclass
from email.utils import parsedate_to_datetime
from pathlib import Path

import aiohttp

from vlog_tpu_torch import config
from vlog_tpu_torch.delivery import gossip
from vlog_tpu_torch.delivery.cache import CacheEntry, FileEntry, SegmentCache, \
    SingleFlight
from vlog_tpu_torch.delivery.gossip import Membership
from vlog_tpu_torch.delivery.http import MEDIA_MIME, MUTABLE_SUFFIXES, \
    parse_retry_after
from vlog_tpu_torch.delivery.l2 import DiskL2
from vlog_tpu_torch.delivery.ring import Ring
from vlog_tpu_torch.obs.metrics import runtime
from vlog_tpu_torch.utils import failpoints

log = logging.getLogger("vlog.delivery")

# Publish-state entries (including negative "missing" ones) are tiny;
# this bound only matters under a random-slug 404 storm.
_STATE_CACHE_MAX = 16384
# Per-slug manifest digest maps are bigger (one {rel: (size, sha)} per
# published file); bound them so a long-lived process serving a huge
# catalog doesn't accumulate one map per slug ever touched.
_DIGEST_CACHE_MAX = 2048
# Requests carrying this header are peer fills from another origin:
# they must answer from local tiers only (never re-enter the ring), or
# a misconfigured ring could chase ownership in a cycle.
PEER_FILL_HEADER = "X-Vlog-Peer-Fill"
# Cross-origin fill-correlation token: peer fetches carry the object
# digest here, so an origin that already has the same fill in flight
# coalesces the request onto it (counted) instead of starting another —
# the flash-crowd one-disk-read-fleet-wide mechanism.
FILL_TOKEN_HEADER = "X-Vlog-Fill-Token"
# Media-segment suffixes the prewarm pass considers (CMAF + TS).
_SEGMENT_SUFFIXES = (".m4s", ".ts")
# Per-slug heat records are two floats; bound the map so a random-slug
# 404 storm cannot grow it without limit.
_HEAT_MAX = 4096
# Fill-latency reservoir feeding the p95-adaptive hedge budget: sample
# count kept, and the minimum before adaptivity kicks in.
_FILL_SAMPLES = 256
_FILL_SAMPLE_MIN = 32


class LoadShedError(RuntimeError):
    """Admission refused: too many origin reads in flight (HTTP 503)."""

    def __init__(self, retry_after_s: int = 1):
        super().__init__("origin overloaded; retry shortly")
        self.retry_after_s = retry_after_s


class MediaEscapeError(PermissionError):
    """A resolved path escaped the slug's tree (symlink traversal)."""


class PeerFillError(RuntimeError):
    """A peer fetch came back unusable (status, digest, transport)."""


@dataclass(frozen=True)
class ServingState:
    """What the media route needs to gate a request — nothing more."""

    video_id: int | None
    status: str                 # 'ready' | 'deleted' | 'missing' | other


class DeliveryPlane:
    """One per serving process; constructed by ``build_public_app``."""

    def __init__(self, db, video_dir: str | Path, *,
                 cache_bytes: int | None = None,
                 max_inflight_reads: int | None = None,
                 manifest_ttl_s: float | None = None,
                 segment_ttl_s: float | None = None,
                 state_ttl_s: float | None = None,
                 max_entry_bytes: int | None = None,
                 l2_bytes: int | None = None,
                 l2_dir: str | Path | None = None,
                 peers: tuple[str, ...] | list[str] | None = None,
                 self_url: str | None = None,
                 peer_timeout_s: float | None = None,
                 prewarm_segments: int | None = None,
                 sendfile_bytes: int | None = None,
                 peer_cooldown_s: float | None = None,
                 hedge_ms: float | None = None,
                 gossip_interval_s: float | None = None,
                 heat_halflife_s: float | None = None,
                 l2_admit_heat: float | None = None,
                 l2_hot_heat: float | None = None):
        self.db = db
        self.video_dir = Path(video_dir)
        self.max_inflight_reads = (config.DELIVERY_MAX_INFLIGHT_READS
                                   if max_inflight_reads is None
                                   else max_inflight_reads)
        self.manifest_ttl_s = (config.DELIVERY_MANIFEST_TTL_S
                               if manifest_ttl_s is None else manifest_ttl_s)
        self.segment_ttl_s = (config.DELIVERY_SEGMENT_TTL_S
                              if segment_ttl_s is None else segment_ttl_s)
        self.state_ttl_s = (config.DELIVERY_STATE_TTL_S
                            if state_ttl_s is None else state_ttl_s)
        self.max_entry_bytes = (config.DELIVERY_MAX_ENTRY_BYTES
                                if max_entry_bytes is None
                                else max_entry_bytes)
        self.peer_timeout_s = (config.DELIVERY_PEER_TIMEOUT_S
                               if peer_timeout_s is None else peer_timeout_s)
        self.prewarm_segments = (config.DELIVERY_PREWARM_SEGMENTS
                                 if prewarm_segments is None
                                 else prewarm_segments)
        self.sendfile_bytes = (config.DELIVERY_SENDFILE_BYTES
                               if sendfile_bytes is None else sendfile_bytes)
        self.peer_cooldown_s = (config.DELIVERY_PEER_COOLDOWN_S
                                if peer_cooldown_s is None
                                else peer_cooldown_s)
        self.hedge_ms = (config.DELIVERY_HEDGE_MS
                         if hedge_ms is None else hedge_ms)
        self.gossip_interval_s = (config.DELIVERY_GOSSIP_INTERVAL_S
                                  if gossip_interval_s is None
                                  else gossip_interval_s)
        self.heat_halflife_s = (config.DELIVERY_HEAT_HALFLIFE_S
                                if heat_halflife_s is None
                                else heat_halflife_s)
        m = runtime()
        self.cache = SegmentCache(
            config.DELIVERY_CACHE_BYTES if cache_bytes is None
            else cache_bytes,
            on_evict=self._on_l1_evict)
        self.flight = SingleFlight(
            on_collapse=lambda: m.delivery_collapses.inc())
        self.l2 = DiskL2(
            config.DELIVERY_L2_DIR if l2_dir is None else l2_dir,
            config.DELIVERY_L2_BYTES if l2_bytes is None else l2_bytes,
            on_evict=lambda _n: runtime().delivery_l2_evictions.inc(),
            on_rescue=lambda n: runtime().delivery_l2_rescues.inc(n),
            admit_heat=(config.DELIVERY_L2_ADMIT_HEAT
                        if l2_admit_heat is None else l2_admit_heat),
            hot_heat=(config.DELIVERY_L2_HOT_HEAT
                      if l2_hot_heat is None else l2_hot_heat))
        peer_list = config.DELIVERY_PEERS if peers is None else peers
        own_url = config.DELIVERY_SELF_URL if self_url is None else self_url
        self.ring = Ring(peer_list, own_url)
        # gossip membership: the live view behind the ring. Seeded from
        # the same peer list, but transitions (death, quarantine, join,
        # rejoin) bump its version and _current_ring rebuilds.
        self.membership = Membership(
            peer_list, own_url,
            suspect_after=config.DELIVERY_GOSSIP_SUSPECT_AFTER,
            down_after_s=config.DELIVERY_GOSSIP_DOWN_S,
            quarantine_s=config.DELIVERY_GOSSIP_QUARANTINE_S)
        # loop-confined: _states/_fill_gen/_inflight_reads/_peer_down/
        # _tasks/_http are only touched from event-loop coroutines,
        # never from fill threads
        self._states: dict[str, tuple[ServingState, float]] = {}
        self._peer_down: dict[str, float] = {}      # peer -> retry-at
        self._tasks: set[asyncio.Task] = set()      # spills + prewarms
        self._http: aiohttp.ClientSession | None = None
        # fill-latency reservoir (seconds) behind the p95-adaptive
        # hedge budget; appended on the loop after each fill
        self._fill_times: deque[float] = deque(maxlen=_FILL_SAMPLES)
        # slug -> (outputs.json mtime_ns | None, {rel: (size, sha256)})
        # — read AND refreshed inside fill workers running in
        # asyncio.to_thread: concurrent fills for two slugs would
        # otherwise race the dict (and the bound/clear)
        self._digest_lock = threading.Lock()      # lock-order: 50
        # guarded-by: _digest_lock
        self._digests: dict[str, tuple[int | None,
                                       dict[str, tuple[int, str]]]] = {}
        self._root_resolved: Path | None = None
        self._inflight_reads = 0
        # bumped by every invalidation: a fill that straddles one must
        # not cache what it read (the tree may have been rewritten
        # between its read and its put)
        self._fill_gen = 0
        # hot counters are bumped from event-loop coroutines AND from
        # to_thread fill workers (spills, prewarm bookkeeping), so they
        # live behind a lock; _bump is the one write path
        self._counter_lock = threading.Lock()     # lock-order: 52
        # guarded-by: _counter_lock
        self.counters = {
            "hits": 0, "misses": 0, "bypass": 0, "shed": 0,
            "disk_reads": 0, "state_hits": 0, "state_misses": 0,
            "state_stale": 0, "invalidations": 0,
            "peer_fills": 0, "peer_errors": 0, "sendfile": 0,
            "prewarm_runs": 0, "prewarm_segments": 0, "prewarm_errors": 0,
            "hedges": 0, "hedge_wins": 0, "coalesced_fills": 0,
            "peer_quarantines": 0,
        }
        # per-slug (heat, last-touch) — bumped on the event loop per
        # request, read from to_thread spill workers at admission time
        # guarded-by: _counter_lock
        self._heat: dict[str, tuple[float, float]] = {}
        register(self)

    def _bump(self, key: str, n: int = 1) -> None:
        with self._counter_lock:
            self.counters[key] += n

    # -- publish-state gate ------------------------------------------------

    async def serving_state(self, slug: str) -> ServingState:
        """ready/deleted/missing for one slug, DB-free in steady state."""
        now = time.monotonic()
        cached = self._states.get(slug)
        if cached is not None and now < cached[1]:
            self._bump("state_hits")
            return cached[0]
        self._bump("state_misses")
        from vlog_tpu_torch.jobs import videos as vids   # lazy: no import cycle

        try:
            row = await vids.get_video_serving_state(self.db, slug)
        except Exception as exc:  # noqa: BLE001 — classified below
            from vlog_tpu_torch.db.retry import is_transient_db_error

            if cached is None or not is_transient_db_error(exc):
                raise
            # Stale-while-unavailable: the coordination plane is
            # flapping (brownout) but this slug's last known publish
            # state is in hand — keep playback alive on it rather than
            # 500 every viewer. Re-extend by one TTL so a flap costs one
            # probe per slug per TTL, not one per request.
            self._bump("state_stale")
            runtime().delivery_stale_state.inc()
            st = cached[0]
            self._states[slug] = (st, now + self.state_ttl_s)
            return st
        if row is None:
            st = ServingState(None, "missing")
        elif row["deleted_at"]:
            st = ServingState(row["id"], "deleted")
        else:
            st = ServingState(row["id"], row["status"])
        if len(self._states) >= _STATE_CACHE_MAX:
            self._states.clear()        # coarse but bounded; re-warms
        self._states[slug] = (st, now + self.state_ttl_s)
        return st

    # -- segment fetch -----------------------------------------------------

    async def fetch(self, slug: str, rel: str, *, allow_peer: bool = True,
                    fill_token: str | None = None
                    ) -> CacheEntry | FileEntry:
        """The media body for ``slug/rel`` — L1, then L2, then the ring
        owner (hedged), then local disk, via single-flight under the
        admission bound. ``allow_peer=False`` (requests already carrying
        the peer-fill header) answers from local tiers only.

        ``fill_token`` is the cross-origin fill-correlation token
        (:data:`FILL_TOKEN_HEADER`): a tokened request that lands while
        the same object's fill is already in flight here coalesces onto
        it and is counted — the flash-crowd one-disk-read proof.

        Raises FileNotFoundError (404), :class:`MediaEscapeError`
        (symlink traversal, also a 404 — don't leak tree shape),
        :class:`LoadShedError` (503), and any armed
        ``delivery.read`` failpoint error (the fill fails, nothing is
        cached, the next request retries).
        """
        self._touch_heat(slug)
        entry = self.cache.get((slug, rel))
        if entry is not None:
            self._bump("hits")
            m = runtime()
            m.delivery_requests.labels("hit").inc()
            m.delivery_bytes.labels("cache").inc(entry.size)
            return entry
        if fill_token is not None and self.flight.pending((slug, rel)):
            self._bump("coalesced_fills")
            runtime().delivery_coalesced_fills.inc()
        return await self.flight.run(
            (slug, rel),
            lambda: self._fill(slug, rel, allow_peer, fill_token))

    async def _fill(self, slug: str, rel: str, allow_peer: bool,
                    fill_token: str | None = None
                    ) -> CacheEntry | FileEntry:
        # a just-finished leader may have filled it while we queued
        entry = self.cache.get((slug, rel))
        if entry is not None:
            self._bump("hits")
            runtime().delivery_requests.labels("hit").inc()
            runtime().delivery_bytes.labels("cache").inc(entry.size)
            return entry
        m = runtime()
        try:
            failpoints.hit("delivery.shed")
        except failpoints.FailpointError:
            self._bump("shed")
            m.delivery_requests.labels("shed").inc()
            raise LoadShedError() from None
        if self._inflight_reads >= self.max_inflight_reads:
            self._bump("shed")
            m.delivery_requests.labels("shed").inc()
            raise LoadShedError()
        self._inflight_reads += 1
        m.delivery_inflight_reads.set(self._inflight_reads)
        gen = self._fill_gen
        source = "disk"
        t0 = time.monotonic()
        try:
            got: CacheEntry | FileEntry | None = None
            kind, meta = await asyncio.to_thread(self._pre_fill, slug, rel)
            if kind == "l2":
                digest, size, body, mtime = meta
                m.delivery_l2_requests.labels("hit").inc()
                m.delivery_bytes.labels("l2").inc(size)
                source = "l2"
                if size >= self.sendfile_bytes:
                    got = FileEntry(
                        slug=slug, rel=rel, path=self.l2.path_for(digest),
                        size=size, etag=f'"{digest}"', mime=_mime_for(rel),
                        mtime=mtime, immutable=True, digest=digest)
                else:
                    got = self._entry_from_bytes(slug, rel, digest, body,
                                                 mtime)
            else:
                if kind in ("miss", "corrupt") and self.l2.enabled:
                    m.delivery_l2_requests.labels(kind).inc()
                if meta is not None and allow_peer:
                    digest, _size = meta
                    if fill_token is None:
                        got = await self._peer_fetch(slug, rel, digest)
                    else:
                        got = await self._peer_fetch(slug, rel, digest,
                                                     fill_token)
                    if got is not None:
                        source = "peer"
                        m.delivery_bytes.labels("peer").inc(got.size)
                        self._store_l2_soon(got)
            if got is None:
                got = await asyncio.to_thread(self._read_entry, slug, rel)
                self._bump("disk_reads")
                if isinstance(got, CacheEntry):
                    m.delivery_bytes.labels("disk").inc(got.size)
                    self._store_l2_soon(got)
        finally:
            self._inflight_reads -= 1
            m.delivery_inflight_reads.set(self._inflight_reads)
        # feed the latency reservoir behind the p95-adaptive hedge
        # budget (and the fill histogram) with the winning source
        dt = time.monotonic() - t0
        self._fill_times.append(dt)
        if source in ("l2", "peer"):
            fill_label = source
        elif isinstance(got, FileEntry):
            fill_label = "bypass"
        else:
            fill_label = "disk"
        m.delivery_fill_seconds.labels(fill_label).observe(dt)
        if source == "l2":
            m.delivery_requests.labels("l2_hit").inc()
        elif source == "peer":
            self._bump("peer_fills")
            m.delivery_requests.labels("peer_fill").inc()
        elif isinstance(got, FileEntry):
            self._bump("bypass")
            m.delivery_requests.labels("bypass").inc()
        else:
            self._bump("misses")
            m.delivery_requests.labels("miss").inc()
        if isinstance(got, FileEntry):
            self._bump("sendfile")
        elif gen == self._fill_gen:
            # an invalidation mid-fill means these bytes may predate a
            # tree rewrite: serve them to the waiters, cache nothing
            self.cache.put(got)
            m.delivery_cache_bytes.set(self.cache.bytes_cached)
        return got

    # -- peer fill (event loop: aiohttp client) ----------------------------

    def _current_ring(self) -> Ring:
        """The live rendezvous view. Rebuilt from gossip membership only
        when the membership version has moved past the ring's — a ring
        installed directly (tests, static deployments with gossip off)
        keeps version 0 on both sides and is never clobbered."""
        mv = self.membership.version
        if mv and mv != self.ring.version:
            self.ring = self.membership.ring()
            runtime().delivery_ring_version.set(self.ring.version)
        return self.ring

    def _hedge_delay_s(self) -> float | None:
        """The hedge launch budget: ``hedge_ms`` until enough fill
        samples accumulate, then the observed p95 clamped to
        [hedge_ms/4, hedge_ms*4]. None disables hedging."""
        if self.hedge_ms <= 0:
            return None
        base = self.hedge_ms / 1000.0
        if len(self._fill_times) < _FILL_SAMPLE_MIN:
            return base
        ordered = sorted(self._fill_times)
        p95 = ordered[min(len(ordered) - 1, int(len(ordered) * 0.95))]
        return min(max(p95, base / 4.0), base * 4.0)

    async def _peer_fetch(self, slug: str, rel: str, digest: str,
                          fill_token: str | None = None
                          ) -> CacheEntry | None:
        """Fetch one digest-known object from the ring, hedged; None
        means 'fall back to local fill' (owner-is-us, no healthy
        candidate, or every contacted peer failed).

        Candidates are the rendezvous-ranked healthy peers for the key:
        the owner first, then the peer a hedge should try. Peers in
        cooldown or gossip-unhealthy (suspect/down/quarantined) are
        skipped outright — that is the routed-around-within-one-
        suspect-window guarantee."""
        key = f"{slug}/{rel}"
        ring = self._current_ring()
        if ring.is_local(key):
            return None
        now = time.monotonic()
        candidates: list[str] = []
        for peer in ring.ranked(key):
            if peer == ring.self_url:
                continue
            if self._peer_down.get(peer, 0.0) > now:
                continue
            state = self.membership.state_of(peer)
            if state is not None and state != gossip.ALIVE:
                continue
            candidates.append(peer)
            if len(candidates) == 2:
                break
        if not candidates:
            return None
        delay_s = self._hedge_delay_s()
        if delay_s is None or len(candidates) < 2:
            return await self._peer_fetch_one(slug, rel, digest,
                                              candidates[0], fill_token)
        return await self._peer_fetch_hedged(slug, rel, digest,
                                             candidates, delay_s,
                                             fill_token)

    async def _peer_fetch_hedged(self, slug: str, rel: str, digest: str,
                                 candidates: list[str], delay_s: float,
                                 fill_token: str | None
                                 ) -> CacheEntry | None:
        """Primary fetch to ``candidates[0]``; once it overruns the
        hedge budget, a hedge to ``candidates[1]``. First digest-valid
        response wins; the loser is cancelled (and can never cache —
        entries only exist after the full body verified)."""
        m = runtime()
        primary = asyncio.create_task(
            self._peer_fetch_one(slug, rel, digest, candidates[0],
                                 fill_token),
            name="vlog-peer-fill")
        hedge: asyncio.Task | None = None
        try:
            done, _ = await asyncio.wait({primary}, timeout=delay_s)
            if primary in done:
                entry = primary.result()
                if entry is not None:
                    return entry
                # primary failed *fast* — immediate failover to the
                # next-ranked peer (the budget never elapsed, so this
                # is not counted as a hedge)
                return await self._peer_fetch_one(
                    slug, rel, digest, candidates[1], fill_token)
            self._bump("hedges")
            m.delivery_hedges.labels("launched").inc()
            hedge = asyncio.create_task(
                self._peer_fetch_one(slug, rel, digest, candidates[1],
                                     fill_token),
                name="vlog-peer-hedge")
            pending: set[asyncio.Task] = {primary, hedge}
            while pending:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED)
                for task in done:
                    entry = task.result()  # fetch-one never raises
                    if entry is None:
                        continue
                    if task is hedge:
                        self._bump("hedge_wins")
                        m.delivery_hedges.labels("win").inc()
                    else:
                        m.delivery_hedges.labels("primary_win").inc()
                    return entry
            return None
        finally:
            losers = [t for t in (primary, hedge) if t is not None]
            for task in losers:
                if not task.done():
                    task.cancel()
            await asyncio.gather(*losers, return_exceptions=True)

    async def _peer_fetch_one(self, slug: str, rel: str, digest: str,
                              peer: str, fill_token: str | None
                              ) -> CacheEntry | None:
        """One digest-verified fetch from one peer; None on any failure
        (classified and fed to cooldown/membership). Never raises except
        CancelledError (a hedge loser), which aborts before any byte
        could be cached."""
        try:
            failpoints.hit("delivery.peer")
        except failpoints.FailpointError as exc:
            self._peer_failed(peer, "transport", exc)
            return None
        try:
            failpoints.hit("delivery.hedge")
        except failpoints.FailpointError as exc:
            # chaos stall: this fetch hangs for the full peer budget,
            # exactly like a wedged-but-connected owner — the hedge to
            # the next-ranked peer is what must rescue the request
            await asyncio.sleep(self.peer_timeout_s)
            self._peer_failed(peer, "timeout", exc)
            return None
        try:
            sess = self._http_session()
            async with sess.get(
                    f"{peer}/videos/{slug}/{rel}",
                    headers={PEER_FILL_HEADER: "1",
                             FILL_TOKEN_HEADER: fill_token or digest},
                    timeout=aiohttp.ClientTimeout(total=self.peer_timeout_s),
            ) as resp:
                if resp.status != 200:
                    retry_after = None
                    if resp.status == 503:
                        # a shedding peer names its own backoff; honor
                        # it as the cooldown instead of the flat knob
                        retry_after = parse_retry_after(
                            resp.headers.get("Retry-After"))
                    self._peer_failed(
                        peer, "status",
                        PeerFillError(f"{peer} answered {resp.status}"),
                        cooldown_s=retry_after)
                    return None
                body = await resp.read()
                last_modified = resp.headers.get("Last-Modified")
        except asyncio.CancelledError:
            raise
        except asyncio.TimeoutError as exc:
            self._peer_failed(peer, "timeout", exc)
            return None
        except Exception as exc:  # noqa: BLE001 — any failure degrades
            self._peer_failed(peer, "transport", exc)
            return None
        if hashlib.sha256(body).hexdigest() != digest:
            # the peer served bytes that don't match the manifest this
            # origin published against — liveness is not trust
            self._peer_failed(peer, "digest", PeerFillError(
                f"{peer} body does not match digest {digest[:12]}…"))
            return None
        self.membership.record_success(peer)
        mtime = _parse_http_date(last_modified)
        runtime().delivery_peer_fills.labels("hit").inc()
        return self._entry_from_bytes(slug, rel, digest, body, mtime)

    def _peer_failed(self, peer: str, kind: str, exc: BaseException, *,
                     cooldown_s: float | None = None) -> None:
        """Classified peer-fill failure. Only transport/timeout feed
        gossip suspicion (the process may be unreachable); a status
        failure just cools the peer down (its own Retry-After wins over
        the knob); a digest liar is quarantined out of ownership."""
        cooldown = (self.peer_cooldown_s if cooldown_s is None
                    else cooldown_s)
        if kind == "digest":
            self.membership.quarantine(peer)
            self._bump("peer_quarantines")
            cooldown = max(cooldown, self.membership.quarantine_s)
        elif kind in ("transport", "timeout"):
            self.membership.record_failure(peer)
        self._peer_down[peer] = time.monotonic() + cooldown
        self._bump("peer_errors")
        runtime().delivery_peer_fills.labels(kind).inc()
        log.warning("peer-fill from %s failed [%s] (%.1fs cooldown): %s",
                    peer, kind, cooldown, exc)

    def _http_session(self) -> aiohttp.ClientSession:
        if self._http is None or self._http.closed:
            self._http = aiohttp.ClientSession()
        return self._http

    # -- gossip membership -------------------------------------------------

    def start_gossip(self) -> bool:
        """Start the membership probe loop on the running event loop;
        False when gossip is disabled, there is no peer to probe, or no
        loop is running here. Called from the app's startup hook."""
        if self.gossip_interval_s <= 0 or not self.membership.enabled:
            return False
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return False
        m = runtime()
        t = loop.create_task(
            gossip.probe_loop(
                self.membership, self._http_session,
                interval_s=self.gossip_interval_s,
                jitter=config.DELIVERY_GOSSIP_JITTER,
                on_outcome=lambda o:
                    m.delivery_gossip_probes.labels(o).inc()),
            name="vlog-delivery-gossip")
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)
        return True

    # -- per-slug heat (popularity signal for the L2) ----------------------

    def _touch_heat(self, slug: str) -> None:
        """One request's worth of heat: +1 onto an exponential decay
        with half-life ``heat_halflife_s``. Bumped on the event loop,
        read from to_thread spill workers — hence the counter lock."""
        now = time.monotonic()
        with self._counter_lock:
            rec = self._heat.get(slug)
            if rec is None:
                if len(self._heat) >= _HEAT_MAX:
                    self._heat.clear()  # coarse but bounded; re-warms
                heat = 1.0
            else:
                heat = rec[0] * 0.5 ** ((now - rec[1])
                                        / self.heat_halflife_s) + 1.0
            self._heat[slug] = (heat, now)

    def heat_of(self, slug: str) -> float:
        """The slug's decayed heat right now (0.0 when never touched)."""
        now = time.monotonic()
        with self._counter_lock:
            rec = self._heat.get(slug)
        if rec is None:
            return 0.0
        return rec[0] * 0.5 ** ((now - rec[1]) / self.heat_halflife_s)

    def heat_top(self, n: int = 10) -> list[tuple[str, float]]:
        """Hottest slugs right now (admin fabric panel)."""
        now = time.monotonic()
        with self._counter_lock:
            items = list(self._heat.items())
        decayed = [(slug, h * 0.5 ** ((now - at) / self.heat_halflife_s))
                   for slug, (h, at) in items]
        decayed.sort(key=lambda kv: kv[1], reverse=True)
        return decayed[:n]

    async def close(self) -> None:
        """Release loop-bound resources (peer HTTP session, background
        spill/prewarm tasks). Called from the app's cleanup hook."""
        for t in list(self._tasks):
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        if self._http is not None and not self._http.closed:
            await self._http.close()

    # -- L2 spill ----------------------------------------------------------

    def _on_l1_evict(self, victim: CacheEntry) -> None:
        runtime().delivery_evictions.inc()
        self._store_l2_soon(victim)

    def _store_l2_soon(self, entry: CacheEntry | FileEntry) -> None:
        """Write-through/spill one digest-covered immutable entry to the
        L2 off the serve path. On the event loop this schedules a
        thread; in loop-less (unit-test) contexts it writes inline."""
        if not self.l2.enabled or not isinstance(entry, CacheEntry):
            return
        if entry.digest is None or not entry.immutable:
            return

        digest, body, mtime = entry.digest, entry.body, entry.mtime
        heat = self.heat_of(entry.slug)     # stamp admission heat now

        def work() -> None:
            if self.l2.put(digest, body, mtime, heat=heat):
                runtime().delivery_l2_bytes.set(self.l2.stats()["bytes"])

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            work()
            return
        t = loop.create_task(asyncio.to_thread(work),
                             name="vlog-delivery-invalidate")
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)

    # -- publish-time prewarm ----------------------------------------------

    def schedule_prewarm(self, slug: str) -> bool:
        """Fire-and-forget prewarm of a freshly published slug; False
        when prewarm is disabled or no loop is running here."""
        if self.prewarm_segments <= 0:
            return False
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return False
        t = loop.create_task(self.prewarm_slug(slug),
                             name="vlog-delivery-prewarm")
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)
        return True

    async def prewarm_slug(self, slug: str) -> dict:
        """Pull every init segment + the first ``prewarm_segments``
        media segments of each rung through the normal fetch path (so
        single-flight, L2 write-through, and the ring all apply)."""
        self._bump("prewarm_runs")
        m = runtime()
        rels = await asyncio.to_thread(self._prewarm_targets, slug)
        warmed = errors = 0
        for rel in rels:
            try:
                await self.fetch(slug, rel)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — prewarm is best-effort
                errors += 1
                m.delivery_prewarm.labels("error").inc()
            else:
                warmed += 1
                m.delivery_prewarm.labels("warmed").inc()
        self._bump("prewarm_segments", warmed)
        self._bump("prewarm_errors", errors)
        return {"slug": slug, "targets": len(rels), "warmed": warmed,
                "errors": errors}

    def _prewarm_targets(self, slug: str) -> list[str]:
        """Init segments + first-N media segments per rung directory,
        straight from the publish manifest (no playlist parsing)."""
        from vlog_tpu_torch.storage import integrity

        _, files = integrity.manifest_digests(self.video_dir / slug)
        inits: list[str] = []
        by_dir: dict[str, list[str]] = {}
        for rel in files:
            name = rel.rsplit("/", 1)[-1]
            if name.startswith("init"):
                inits.append(rel)
            elif Path(name).suffix.lower() in _SEGMENT_SUFFIXES:
                d = rel.rsplit("/", 1)[0] if "/" in rel else ""
                by_dir.setdefault(d, []).append(rel)
        targets = sorted(inits)
        for _, segs in sorted(by_dir.items()):
            targets.extend(sorted(segs)[:self.prewarm_segments])
        return targets

    # -- blocking internals (run in a thread) ------------------------------

    def _pre_fill(self, slug: str, rel: str):
        """L2/ring eligibility + the L2 probe, off-loop.

        Returns one of::

            ("l2",     (digest, size, body, mtime))   # verified L2 hit
            ("miss",   (digest, size))   # digest known, not in L2
            ("corrupt", (digest, size))  # was in L2, failed verify
            ("origin", None)             # mutable / uncovered / bypass
        """
        if not self.l2.enabled and not self.ring.enabled:
            return "origin", None       # single-origin: no extra stat
        if Path(rel).suffix.lower() in MUTABLE_SUFFIXES:
            return "origin", None       # playlists mutate: local + TTL
        want = self._manifest_meta(slug, rel)
        if want is None:
            return "origin", None       # no manifest coverage: local
        size, digest = want
        if size > self.max_entry_bytes:
            return "origin", None       # bypass objects stream locally
        if not self.l2.enabled:
            return "miss", (digest, size)
        outcome, body, mtime = self.l2.read(digest)
        if outcome == "hit":
            return "l2", (digest, size, body, mtime)
        return outcome, (digest, size)

    def _video_root(self) -> Path:
        if self._root_resolved is None:
            self._root_resolved = self.video_dir.resolve()
        return self._root_resolved

    def _read_entry(self, slug: str, rel: str) -> CacheEntry | FileEntry:
        failpoints.hit("delivery.read")
        raw = self.video_dir / slug / rel
        # ONE resolve per fill (not per hit): the lexical ".." check in
        # the route catches textual traversal; this catches a symlink
        # inside the tree pointing outside VIDEO_DIR/slug.
        resolved = raw.resolve()
        slug_root = self._video_root() / slug
        if not (resolved == slug_root
                or str(resolved).startswith(str(slug_root) + os.sep)):
            raise MediaEscapeError(f"{slug}/{rel} escapes its tree")
        try:
            st = resolved.stat()
        except OSError as exc:
            raise FileNotFoundError(str(raw)) from exc
        if not stat_mod.S_ISREG(st.st_mode):
            raise FileNotFoundError(str(raw))
        suffix = resolved.suffix.lower()
        mime = MEDIA_MIME.get(suffix, "application/octet-stream")
        if st.st_size > self.max_entry_bytes:
            # the bypass still carries the manifest digest when one
            # covers the file, so its validators match the buffered
            # paths (mtime-size fallback otherwise — same as below)
            digest = self._digest_for(slug, rel, st.st_size)
            etag = (f'"{digest}"' if digest is not None
                    else f'"{st.st_mtime_ns:x}-{st.st_size:x}"')
            return FileEntry(
                slug=slug, rel=rel, path=resolved, size=st.st_size,
                etag=etag, mime=mime, mtime=st.st_mtime,
                immutable=suffix not in MUTABLE_SUFFIXES, digest=digest)
        body = resolved.read_bytes()
        digest = self._digest_for(slug, rel, len(body))
        mutable = suffix in MUTABLE_SUFFIXES
        if digest is not None:
            version, etag = digest, f'"{digest}"'
        else:
            version = f"{st.st_mtime_ns:x}"
            etag = f'"{st.st_mtime_ns:x}-{len(body):x}"'
        expires = None
        if mutable:
            expires = time.monotonic() + self.manifest_ttl_s
        elif self.segment_ttl_s > 0:
            # split deployments: bound staleness of republished bodies
            expires = time.monotonic() + self.segment_ttl_s
        return CacheEntry(
            slug=slug, rel=rel, version=version, body=body, etag=etag,
            mime=mime, mtime=st.st_mtime, immutable=not mutable,
            expires_at=expires, digest=digest)

    def _entry_from_bytes(self, slug: str, rel: str, digest: str,
                          body: bytes, mtime: float) -> CacheEntry:
        """A cacheable entry for digest-verified bytes that did NOT come
        from the local origin tree (L2 promotion, peer fill)."""
        expires = None
        if self.segment_ttl_s > 0:
            expires = time.monotonic() + self.segment_ttl_s
        return CacheEntry(
            slug=slug, rel=rel, version=digest, body=body,
            etag=f'"{digest}"', mime=_mime_for(rel), mtime=mtime,
            immutable=True, expires_at=expires, digest=digest)

    def _manifest_meta(self, slug: str, rel: str
                       ) -> tuple[int, str] | None:
        """``(size, sha256)`` from the publish manifest, or None.

        The per-slug digest map loads from ``outputs.json`` on first
        use and revalidates by the manifest's mtime_ns per fill (a stat,
        not a re-read — fills are misses, already off the hot path).
        """
        from vlog_tpu_torch.storage import integrity

        root = self.video_dir / slug
        with self._digest_lock:
            cached = self._digests.get(slug)
        try:
            current_ns = (root / integrity.MANIFEST_NAME).stat().st_mtime_ns
        except OSError:
            current_ns = None
        if cached is None or cached[0] != current_ns:
            # manifest load runs outside the lock (disk I/O); a racing
            # fill for the same slug just loads twice and the second
            # store wins — both loads saw the same manifest bytes
            cached = integrity.manifest_digests(root)
            with self._digest_lock:
                if len(self._digests) >= _DIGEST_CACHE_MAX:
                    self._digests.clear()   # coarse but bounded; re-warms
                self._digests[slug] = cached
        return cached[1].get(rel)

    def _digest_for(self, slug: str, rel: str, size: int) -> str | None:
        """The manifest sha256 for one published file, or None. A size
        mismatch means the manifest is stale for this rel: fall back to
        the mtime ETag rather than lie about content."""
        want = self._manifest_meta(slug, rel)
        if want is None or want[0] != size:
            return None
        return want[1]

    # -- invalidation + stats ---------------------------------------------

    def invalidate_slug(self, slug: str) -> int:
        """Evict everything known about one slug; returns entries
        dropped. The L2 is intentionally untouched: it is addressed by
        content digest, so a republished tree's new manifest simply
        stops resolving to the old objects and they age out by LRU."""
        n = self.cache.invalidate_slug(slug)
        self._states.pop(slug, None)
        with self._digest_lock:
            self._digests.pop(slug, None)
        self._fill_gen += 1
        self._bump("invalidations")
        runtime().delivery_cache_bytes.set(self.cache.bytes_cached)
        return n

    def invalidate_all(self) -> int:
        n = self.cache.clear()
        self._states.clear()
        with self._digest_lock:
            self._digests.clear()
        n += self.l2.clear()            # operator nuke clears disk too
        self._fill_gen += 1
        self._bump("invalidations")
        runtime().delivery_cache_bytes.set(self.cache.bytes_cached)
        runtime().delivery_l2_bytes.set(0)
        return n

    def stats(self) -> dict:
        with self._counter_lock:
            counters = dict(self.counters)
        l2 = self.l2.stats()
        return {
            **counters,
            "single_flight_collapses": self.flight.collapses,
            "evictions": self.cache.evictions,
            "expirations": self.cache.expirations,
            "cache_entries": len(self.cache),
            "cache_bytes": self.cache.bytes_cached,
            "cache_budget_bytes": self.cache.max_bytes,
            "state_entries": len(self._states),
            "inflight_reads": self._inflight_reads,
            "max_inflight_reads": self.max_inflight_reads,
            "l2_hits": l2["hits"],
            "l2_misses": l2["misses"],
            "l2_corrupt": l2["corrupt"],
            "l2_stores": l2["stores"],
            "l2_evictions": l2["evictions"],
            "l2_rescues": l2["rescues"],
            "l2_admit_skips": l2["admit_skips"],
            "l2_bytes": l2["bytes"],
            "l2_budget_bytes": l2["budget_bytes"],
            "l2_entries": l2["entries"],
            "ring": self.ring.membership(),
            "fabric": self.fabric_view(),
        }

    def fabric_view(self) -> dict:
        """The self-healing-fabric panel: live membership, ring version,
        hedge/coalesce rates, current hedge budget, heat top-N."""
        with self._counter_lock:
            hedges = self.counters["hedges"]
            hedge_wins = self.counters["hedge_wins"]
            coalesced = self.counters["coalesced_fills"]
            quarantines = self.counters["peer_quarantines"]
        delay = self._hedge_delay_s()
        return {
            "membership": self.membership.snapshot(),
            "ring_version": self.ring.version,
            "gossip_interval_s": self.gossip_interval_s,
            "hedge_delay_ms": (None if delay is None
                               else round(delay * 1000.0, 1)),
            "hedges": hedges,
            "hedge_wins": hedge_wins,
            "coalesced_fills": coalesced,
            "peer_quarantines": quarantines,
            "heat_top": [{"slug": s, "heat": round(h, 2)}
                         for s, h in self.heat_top(10)],
        }


def _mime_for(rel: str) -> str:
    return MEDIA_MIME.get(Path(rel).suffix.lower(),
                          "application/octet-stream")


def _parse_http_date(value: str | None) -> float:
    """Last-Modified from a peer response -> epoch seconds; the fetch
    time when absent/garbled (a fresh strong-ETag validator either way)."""
    if value:
        try:
            return parsedate_to_datetime(value).timestamp()
        except (TypeError, ValueError):
            pass
    return time.time()


# --------------------------------------------------------------------------
# Process-wide plane registry: the invalidation hooks in jobs/ and the
# admin API fan out here. WeakSet: a plane lives exactly as long as the
# app that built it.
# --------------------------------------------------------------------------

_PLANES: "weakref.WeakSet[DeliveryPlane]" = weakref.WeakSet()


def register(plane: DeliveryPlane) -> None:
    _PLANES.add(plane)


def has_planes() -> bool:
    """Whether this process serves media at all — lets invalidation
    hooks skip their slug lookup in worker/admin-only processes."""
    return len(_PLANES) > 0


def invalidate_slug(slug: str) -> int:
    """Evict one slug from every delivery plane in this process.

    Returns total entries dropped. Safe (a no-op) in processes that
    serve no media — workers and the admin API call it unconditionally.
    """
    return sum(p.invalidate_slug(slug) for p in list(_PLANES))


def invalidate_all() -> int:
    return sum(p.invalidate_all() for p in list(_PLANES))


def prewarm_slug(slug: str) -> int:
    """Schedule publish-time prewarm on every plane in this process;
    returns how many planes scheduled one (0 with prewarm disabled, no
    planes, or no running loop — all fine: prewarm is best-effort)."""
    return sum(1 for p in list(_PLANES) if p.schedule_prewarm(slug))


def stats_snapshot() -> dict:
    """Aggregated + per-plane stats for the admin panel."""
    per_plane = [p.stats() for p in list(_PLANES)]
    totals: dict[str, int] = {}
    for s in per_plane:
        for k, v in s.items():
            if isinstance(v, int):
                totals[k] = totals.get(k, 0) + v
    return {"planes": per_plane, "totals": totals,
            "plane_count": len(per_plane),
            "ring": per_plane[0]["ring"] if per_plane else None,
            "fabric": per_plane[0]["fabric"] if per_plane else None}
