"""The port's delivery plane (``vlog_tpu_torch.delivery``) against the JAX
package's (``vlog_tpu.delivery``).

- The parts, on the same inputs in both packages: ``Ring`` ownership and
  rank order for 1000 keys over several peer sets; ``Membership``
  through one script of failures, silence, quarantine, rejoin, joins and
  merges under an injected clock (states, versions, snapshots);
  ``DiskL2`` filenames (either package reads the other's store) and its
  corrupt-entry handling; ``SegmentCache`` eviction order and
  ``SingleFlight`` collapsing (event-gated, no wall-clock race).
- The plane, in the port: on a database and tree either package wrote,
  a steady-state hit takes zero DB queries and zero disk reads; the ``delivery.read`` and ``delivery.shed`` sites;
  an L2 fill through a second plane given ``l2_bytes``; a corrupt L2
  entry refilled from the origin, never served; ``invalidate_delivery``
  (no query without a plane; with one it evicts and prewarms); a peer
  fill in both directions between the two packages' public apps over
  loopback.

Every plane a test builds is dropped from both packages' process
registries afterwards (``delivery.plane._PLANES``), so ``has_planes()``
is False again for the next test in the worker. Every test that starts
a server runs under an ``asyncio.timeout`` of its own.
"""

from __future__ import annotations

import asyncio
import hashlib
import importlib
import random
import weakref
from pathlib import Path
from types import SimpleNamespace

import pytest
from aiohttp.test_utils import TestClient, TestServer

JAX, PORT = "vlog_tpu", "vlog_tpu_torch"
TIMEOUT_S = 60.0


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def fresh_registries(monkeypatch):
    """Each test sees (and leaves) an empty plane registry in both
    packages."""
    for pkg in (JAX, PORT):
        monkeypatch.setattr(_mod(pkg, "delivery.plane"), "_PLANES",
                            weakref.WeakSet())


async def _open_db(pkg: str, path: Path):
    db = _mod(pkg, "db").Database(f"sqlite:///{path}")
    await db.connect()
    await _mod(pkg, "db").create_all(db)
    return db


async def publish_tree(db, video_dir: Path, *, pkg: str = PORT,
                       title: str = "Demo Clip", n_seg: int = 3,
                       seg_len: int = 4096) -> dict:
    """A ready video row and a small CMAF-shaped tree with its
    ``outputs.json`` (the reference suite's ``_publish_tree``)."""
    vids = _mod(pkg, "jobs.videos")
    integrity = _mod(pkg, "storage.integrity")
    v = await vids.create_video(db, title)
    root = Path(video_dir) / v["slug"]
    (root / "360p").mkdir(parents=True, exist_ok=True)
    (root / "master.m3u8").write_text("#EXTM3U\n# master\n")
    (root / "360p" / "playlist.m3u8").write_text("#EXTM3U\n# variant\n")
    (root / "360p" / "init.mp4").write_bytes(b"\x00init-seg" * 32)
    rng = random.Random(len(title))
    for i in range(1, n_seg + 1):
        body = bytes(rng.randrange(256) for _ in range(seg_len))
        (root / "360p" / f"segment_{i:05d}.m4s").write_bytes(body)
    integrity.write_manifest(root, integrity.build_manifest(root))
    await db.execute("UPDATE videos SET status='ready' WHERE id=:i",
                     {"i": v["id"]})
    return await vids.get_video(db, v["id"])


async def _drain(plane) -> None:
    """Wait out a plane's background spill and prewarm tasks."""
    for _ in range(50):
        tasks = list(plane._tasks)
        if not tasks:
            return
        await asyncio.gather(*tasks, return_exceptions=True)


# --------------------------------------------------------------------------
# Ring
# --------------------------------------------------------------------------

PEER_SETS = [
    ((), ""),
    (("http://a:9000",), "http://a:9000"),
    (("http://a:9000", "http://b:9000"), "http://a:9000"),
    (("http://10.0.0.1:9000", "http://10.0.0.2:9000",
      "http://10.0.0.3:9000/"), "http://10.0.0.2:9000"),
    (tuple(f"http://origin-{i}.example:9000" for i in range(7)), ""),
]


@pytest.mark.parametrize("peers,self_url", PEER_SETS,
                         ids=[f"{len(p)}-peers" for p, _ in PEER_SETS])
def test_ring_ownership_equals_the_reference(peers, self_url):
    from vlog_tpu.delivery.ring import Ring as RefRing
    from vlog_tpu_torch.delivery.ring import Ring

    ref, port = RefRing(peers, self_url), Ring(peers, self_url)
    assert port.enabled == ref.enabled
    assert port.membership() == ref.membership()
    keys = [f"slug{i % 37}/{['360p', '720p', 'audio'][i % 3]}/"
            f"segment_{i:05d}.m4s" for i in range(1000)]
    owners = [port.owner(k) for k in keys]
    assert owners == [ref.owner(k) for k in keys]
    assert [port.ranked(k) for k in keys] == [ref.ranked(k) for k in keys]
    assert [port.is_local(k) for k in keys] == [ref.is_local(k)
                                                 for k in keys]
    if len(peers) > 1:      # the keys spread over every peer
        assert len(set(owners)) == len(peers)


# --------------------------------------------------------------------------
# Membership under an injected clock
# --------------------------------------------------------------------------

def test_membership_transitions_equal_the_reference(monkeypatch):
    clock = SimpleNamespace(t=1000.0)
    fake_time = SimpleNamespace(monotonic=lambda: clock.t)
    members = {}
    for pkg in (JAX, PORT):
        gossip = _mod(pkg, "delivery.gossip")
        monkeypatch.setattr(gossip, "time", fake_time)
        members[pkg] = gossip.Membership(
            ("http://a", "http://b", "http://c"), "http://me",
            suspect_after=2, down_after_s=3.0, quarantine_s=10.0)
    other = _mod(PORT, "delivery.gossip").Membership(
        ("http://a", "http://b", "http://c", "http://e"), "http://d",
        suspect_after=1, down_after_s=0.5, quarantine_s=10.0)

    steps = [
        (0.0, lambda m: m.record_failure("http://a")),
        (0.5, lambda m: m.record_failure("http://a")),   # suspect
        (1.0, lambda m: m.tick()),
        (3.0, lambda m: m.tick()),                        # down
        (0.2, lambda m: m.record_failure("http://c")),
        (0.1, lambda m: m.record_success("http://a")),    # rejoin
        (0.0, lambda m: m.quarantine("http://b")),
        (5.0, lambda m: m.record_success("http://b")),    # still out
        (6.0, lambda m: m.tick()),                        # served out
        (0.0, lambda m: m.record_success("http://b")),
        (0.0, lambda m: m.heard_from("http://d")),        # join
        (0.3, lambda m: m.merge(other.snapshot())),
        (4.0, lambda m: m.tick()),
        (0.0, lambda m: m.record_failure("http://e")),
        (0.0, lambda m: m.record_failure("http://e")),
        (4.0, lambda m: m.tick()),
    ]
    other.record_failure("http://c")        # the view merged at step 12
    clock.t += 1.0
    other.tick()
    seen_states = set()
    for dt, step in steps:
        clock.t += dt
        out = {pkg: step(m) for pkg, m in members.items()}
        assert out[PORT] == out[JAX]
        ref, port = members[JAX], members[PORT]
        assert port.version == ref.version
        assert port.members() == ref.members()
        assert port.known_peers() == ref.known_peers()
        assert port.snapshot() == ref.snapshot()
        for peer in ref.known_peers():
            assert port.state_of(peer) == ref.state_of(peer)
            assert port.routable(peer) == ref.routable(peer)
            seen_states.add(ref.state_of(peer))
        assert port.ring().membership() == ref.ring().membership()
    assert seen_states == {"alive", "suspect", "down", "quarantined"}
    assert members[PORT].version >= 4


# --------------------------------------------------------------------------
# DiskL2
# --------------------------------------------------------------------------

def _bodies(n: int = 6) -> list[bytes]:
    rng = random.Random(7)
    return [bytes(rng.randrange(256) for _ in range(100 + 37 * i))
            for i in range(n)]


def test_l2_filenames_equal_and_cross_read(tmp_path):
    from vlog_tpu.delivery.l2 import DiskL2 as RefL2
    from vlog_tpu_torch.delivery.l2 import DiskL2

    stores = {JAX: RefL2(tmp_path / "ref", 10_000),
              PORT: DiskL2(tmp_path / "port", 10_000)}
    digests = []
    for i, body in enumerate(_bodies()):
        digest = hashlib.sha256(body).hexdigest()
        digests.append(digest)
        for l2 in stores.values():
            assert l2.put(digest, body, 1000.0 + i)
    names = {pkg: sorted(str(p.relative_to(tmp_path / d))
                         for p in (tmp_path / d).rglob("*") if p.is_file())
             for pkg, d in ((JAX, "ref"), (PORT, "port"))}
    assert names[PORT] == names[JAX] and len(names[PORT]) == 6
    assert [stores[PORT].path_for(d).relative_to(tmp_path / "port")
            for d in digests] == [
        stores[JAX].path_for(d).relative_to(tmp_path / "ref")
        for d in digests]
    # a store the reference wrote, reopened by the port (and the other
    # way): the same hits, bytes and origin mtimes
    reopened = {PORT: DiskL2(tmp_path / "ref", 10_000),
                JAX: RefL2(tmp_path / "port", 10_000)}
    for i, (digest, body) in enumerate(zip(digests, _bodies())):
        for l2 in reopened.values():
            assert l2.read(digest) == ("hit", body, 1000.0 + i)
    assert reopened[PORT].stats() == reopened[JAX].stats()


def test_l2_corrupt_entry_is_deleted_and_never_served(tmp_path):
    from vlog_tpu.delivery.l2 import DiskL2 as RefL2
    from vlog_tpu_torch.delivery.l2 import DiskL2

    outcomes = {}
    for pkg, cls in ((JAX, RefL2), (PORT, DiskL2)):
        l2 = cls(tmp_path / pkg, 10_000)
        good = b"good segment bytes"
        digest = hashlib.sha256(good).hexdigest()
        assert l2.put(digest, good, 5.0)
        l2.path_for(digest).write_bytes(b"evil segment bytes")   # same size
        first = l2.read(digest)
        gone = not l2.path_for(digest).exists()
        second = l2.read(digest)
        trunc = b"z" * 500
        d2 = hashlib.sha256(trunc).hexdigest()
        assert l2.put(d2, trunc, 6.0)
        l2.path_for(d2).write_bytes(trunc[:123])
        third = l2.read(d2)
        outcomes[pkg] = (first, gone, second, third, l2.stats())
    assert outcomes[PORT] == outcomes[JAX]
    first, gone, second, third, stats = outcomes[PORT]
    assert first == ("corrupt", None, 0.0) and gone
    assert second[0] == "miss" and third[0] == "corrupt"
    assert stats["corrupt"] == 2


# --------------------------------------------------------------------------
# SegmentCache and SingleFlight
# --------------------------------------------------------------------------

def _cache_script(pkg: str) -> list:
    cache_mod = _mod(pkg, "delivery.cache")
    evicted = []
    cache = cache_mod.SegmentCache(1000, on_evict=lambda e: evicted.append(
        (e.slug, e.rel)))

    def entry(slug, rel, n, *, expires_at=None):
        return cache_mod.CacheEntry(
            slug=slug, rel=rel, version="v", body=bytes([n % 256]) * n,
            etag=f'"{slug}{rel}"', mime="video/iso.segment", mtime=1.0,
            immutable=expires_at is None, expires_at=expires_at)

    trace = []
    for i in range(6):
        trace.append(cache.put(entry("a" if i % 2 else "b", f"s{i}", 180)))
    trace.append(cache.get(("b", "s0")) is not None)      # touch s0
    trace.append(cache.put(entry("c", "big", 400)))
    trace.append(cache.put(entry("c", "huge", 1001)))      # over budget
    trace.append(cache.put(entry("a", "pl", 50, expires_at=10.0)))
    trace.append(cache.get(("a", "pl"), now=5.0) is not None)
    trace.append(cache.get(("a", "pl"), now=11.0) is not None)
    trace.append(cache.invalidate_slug("a"))
    trace.append((cache.bytes_cached, len(cache), cache.evictions,
                  cache.expirations))
    trace.append(list(evicted))
    return trace


def test_segment_cache_script_equals_the_reference():
    assert _cache_script(PORT) == _cache_script(JAX)


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_single_flight_collapses_onto_one_call(pkg, run):
    """Eight concurrent misses for one key wait on a gate the test
    opens: one call, seven collapses, every waiter gets the leader's
    result; a failed leader fails its waiters and caches nothing."""
    SingleFlight = _mod(pkg, "delivery.cache").SingleFlight

    async def go():
        collapses = []
        flight = SingleFlight(on_collapse=lambda: collapses.append(1))
        gate = asyncio.Event()
        calls = []

        async def fill():
            calls.append(1)
            await gate.wait()
            return "body"

        waiters = [asyncio.create_task(flight.run("k", fill))
                   for _ in range(8)]
        while not flight.pending("k") or len(collapses) < 7:
            await asyncio.sleep(0)
        gate.set()
        assert await asyncio.gather(*waiters) == ["body"] * 8
        assert (len(calls), len(collapses), flight.collapses) == (1, 7, 7)
        assert not flight.pending("k") and flight.inflight() == 0

        async def boom():
            raise OSError("disk gone")

        with pytest.raises(OSError):
            await flight.run("k", boom)
        assert await flight.run("k", fill) == "body"    # not poisoned

    run(asyncio.wait_for(go(), TIMEOUT_S))


# --------------------------------------------------------------------------
# The plane, in the port
# --------------------------------------------------------------------------

@pytest.mark.parametrize("writer", [JAX, PORT])
def test_hit_takes_zero_queries_and_zero_disk_reads(writer, run, tmp_path,
                                                    monkeypatch):
    """The database and tree written by ``writer``'s package, served
    unchanged by the port's plane."""
    from vlog_tpu_torch.db import Database
    from vlog_tpu_torch.delivery import DeliveryPlane

    async def go():
        wdb = await _open_db(writer, tmp_path / "v.db")
        video = await publish_tree(wdb, tmp_path / "videos", pkg=writer)
        await wdb.disconnect()
        db = Database(f"sqlite:///{tmp_path / 'v.db'}")
        await db.connect()
        try:
            plane = DeliveryPlane(db, tmp_path / "videos")
            slug, rel = video["slug"], "360p/segment_00001.m4s"
            want = (tmp_path / "videos" / slug / rel).read_bytes()
            assert (await plane.serving_state(slug)).status == "ready"
            miss = await plane.fetch(slug, rel)
            assert miss.body == want
            assert plane.counters["disk_reads"] == 1
            opened = []
            real_open = Path.open
            monkeypatch.setattr(Path, "open", lambda self, *a, **k: (
                opened.append(self), real_open(self, *a, **k))[1])
            q0 = db.query_count
            for _ in range(5):
                assert (await plane.serving_state(slug)).status == "ready"
                hit = await plane.fetch(slug, rel)
                assert hit is miss
            assert db.query_count == q0 and opened == []
            assert plane.counters["disk_reads"] == 1
            assert plane.counters["hits"] == 5
            await plane.close()
        finally:
            await db.disconnect()

    run(asyncio.wait_for(go(), TIMEOUT_S))


def test_read_and_shed_failpoints(run, tmp_path):
    from vlog_tpu_torch.delivery import DeliveryPlane, LoadShedError
    from vlog_tpu_torch.obs.metrics import runtime
    from vlog_tpu_torch.utils import failpoints

    async def go():
        db = await _open_db(PORT, tmp_path / "v.db")
        try:
            video = await publish_tree(db, tmp_path / "videos")
            plane = DeliveryPlane(db, tmp_path / "videos")
            slug, rel = video["slug"], "360p/segment_00002.m4s"
            shed0 = runtime().delivery_requests.labels("shed")._value.get()
            failpoints.arm_from_spec("delivery.shed=1,delivery.read=1")
            try:
                with pytest.raises(LoadShedError):
                    await plane.fetch(slug, rel)
                with pytest.raises(failpoints.FailpointError):
                    await plane.fetch(slug, rel)
                assert plane.cache.get((slug, rel)) is None
                got = await plane.fetch(slug, rel)    # budgets spent
            finally:
                failpoints.reset()
            assert got.body == (tmp_path / "videos" / slug / rel
                                ).read_bytes()
            assert plane.counters["shed"] == 1
            assert runtime().delivery_requests.labels(
                "shed")._value.get() == shed0 + 1
            await plane.close()
        finally:
            await db.disconnect()

    run(asyncio.wait_for(go(), TIMEOUT_S))


def test_l2_fills_a_second_plane_and_refills_a_corrupt_entry(run, tmp_path):
    """``l2_bytes`` (and ``l2_dir``) given to the constructor: the first
    plane's fill writes through to the disk L2, a second plane over the
    same store serves it with no origin read; a corrupted L2 object is
    refilled from the origin and never served."""
    from vlog_tpu_torch.delivery import DeliveryPlane

    async def go():
        db = await _open_db(PORT, tmp_path / "v.db")
        try:
            video = await publish_tree(db, tmp_path / "videos")
            slug, rel = video["slug"], "360p/segment_00003.m4s"
            want = (tmp_path / "videos" / slug / rel).read_bytes()
            l2 = dict(l2_bytes=1 << 20, l2_dir=tmp_path / "l2")
            first = DeliveryPlane(db, tmp_path / "videos", **l2)
            assert (await first.fetch(slug, rel)).body == want
            await _drain(first)
            digest = hashlib.sha256(want).hexdigest()
            assert first.l2.path_for(digest).read_bytes() == want
            second = DeliveryPlane(db, tmp_path / "videos", **l2)
            assert (await second.fetch(slug, rel)).body == want
            assert second.counters["disk_reads"] == 0
            assert second.l2.stats()["hits"] == 1
            # rot the stored object in place (same size)
            second.l2.path_for(digest).write_bytes(bytes(len(want)))
            third = DeliveryPlane(db, tmp_path / "videos", **l2)
            assert (await third.fetch(slug, rel)).body == want
            assert third.counters["disk_reads"] == 1
            assert third.l2.stats()["corrupt"] == 1
            for plane in (first, second, third):
                await plane.close()
        finally:
            await db.disconnect()

    run(asyncio.wait_for(go(), TIMEOUT_S))


def test_invalidate_delivery_evicts_and_prewarms(run, tmp_path):
    """Without a plane in the process, ``invalidate_delivery`` sends no
    query (a worker process); with one, ``finalize_ready`` evicts the
    slug and prewarms every init segment and the leading media
    segments."""
    from vlog_tpu_torch import delivery
    from vlog_tpu_torch.jobs import videos as vids

    async def go():
        db = await _open_db(PORT, tmp_path / "v.db")
        try:
            video = await publish_tree(db, tmp_path / "videos", n_seg=4)
            slug = video["slug"]
            assert not delivery.has_planes()
            q0 = db.query_count
            await vids.invalidate_delivery(db, video["id"], prewarm=True)
            assert db.query_count == q0
            plane = delivery.DeliveryPlane(db, tmp_path / "videos",
                                           prewarm_segments=2)
            assert delivery.has_planes()
            stale = (slug, "360p/segment_00004.m4s")
            await plane.fetch(*stale)
            await vids.finalize_ready(
                db, video["id"],
                probe=SimpleNamespace(duration_s=4.0, width=128, height=96,
                                      fps=24.0),
                qualities=[], thumbnail_path=None)
            await _drain(plane)
            assert plane.cache.get(stale) is None
            for rel in ("360p/init.mp4", "360p/segment_00001.m4s",
                        "360p/segment_00002.m4s"):
                assert plane.cache.get((slug, rel)) is not None, rel
            assert plane.cache.get((slug, "360p/segment_00003.m4s")) is None
            assert plane.counters["invalidations"] == 1
            assert (plane.counters["prewarm_runs"],
                    plane.counters["prewarm_segments"],
                    plane.counters["prewarm_errors"]) == (1, 3, 0)
            snap = delivery.stats_snapshot()
            assert snap["plane_count"] == 1
            assert snap["totals"]["prewarm_segments"] == 3
            await plane.close()
        finally:
            await db.disconnect()

    run(asyncio.wait_for(go(), TIMEOUT_S))


@pytest.mark.parametrize("owner,edge", [(JAX, PORT), (PORT, JAX)],
                         ids=["port-fills-from-jax", "jax-fills-from-port"])
def test_peer_fill_across_packages(owner, edge, run, tmp_path):
    """One package's public app owns every key of a two-origin ring; the
    other package's plane (which owns nothing) fills from it over
    loopback, digest-checked, with no local disk read."""
    async def go():
        db_owner = await _open_db(owner, tmp_path / "v.db")
        db_edge = _mod(edge, "db").Database(f"sqlite:///{tmp_path / 'v.db'}")
        await db_edge.connect()
        client = None
        try:
            video = await publish_tree(db_owner, tmp_path / "videos",
                                       pkg=owner)
            app = _mod(owner, "api.public_api").build_public_app(
                db_owner, video_dir=tmp_path / "videos")
            client = TestClient(TestServer(app))
            await client.start_server()
            owner_url = str(client.server.make_url("")).rstrip("/")
            plane = _mod(edge, "delivery").DeliveryPlane(
                db_edge, tmp_path / "videos", peers=(owner_url,),
                self_url="http://not-the-owner", gossip_interval_s=0)
            slug, rel = video["slug"], "360p/segment_00001.m4s"
            want = (tmp_path / "videos" / slug / rel).read_bytes()
            got = await plane.fetch(slug, rel)
            assert got.body == want
            assert got.etag == f'"{hashlib.sha256(want).hexdigest()}"'
            assert plane.counters["peer_fills"] == 1
            assert plane.counters["disk_reads"] == 0
            owner_plane = app[_mod(owner, "api.public_api").DELIVERY]
            assert owner_plane.counters["misses"] == 1
            assert (await plane.fetch(slug, rel)).body == want  # L1 hit
            assert plane.counters["peer_fills"] == 1
            await plane.close()
        finally:
            if client is not None:
                await client.close()
            await db_edge.disconnect()
            await db_owner.disconnect()

    run(asyncio.wait_for(go(), TIMEOUT_S))
