"""The port's public API (``vlog_tpu_torch.api.public_api``) against the JAX
package's, both apps on one sqlite database and one tree on disk.

The tree is made by the port's ``process_video`` on the CPU from a 96x128
Y4M (24 frames: an init and a media segment, a thumbnail, the
playlists, ``outputs.json``) and
published with the port's ``finalize_ready``; the database holds ready,
pending and deleted videos, chapters, a transcript, playlists and display
settings.

- Both apps register the same route table.
- Every JSON route answers both apps alike (session tokens masked); the
  session routes leave equal ``playback_sessions`` rows.
- Every media request answers alike, status, body and the headers
  ``ETag``, ``Last-Modified``, ``Content-Type``, ``Content-Length``,
  ``Content-Range``, ``Cache-Control`` and CORS: ``GET`` and ``HEAD`` of
  every file of ``outputs.json``, and on a segment and a playlist
  ``Range``, ``If-None-Match``, ``If-Range``, ``OPTIONS``; 403 on
  ``original*`` with downloads disabled, 404 on a tree that is not
  ready, 400 on a path too deep. Served from RAM and through the sendfile
  bypass.
- A steady-state hit takes zero DB queries and zero disk opens.
- Two origins on a ring of two, one app of each package: each fills the
  keys the other owns from it over loopback.
- ``finalize_ready`` evicts and prewarms the serving app's plane, alike
  in both packages.

Every test that starts a server runs under an ``asyncio.timeout``.
"""

from __future__ import annotations

import asyncio
import hashlib
import importlib
import json
import shutil
import socket
import sqlite3
import weakref
from pathlib import Path

import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from tests.fixtures.media import make_y4m

JAX, PORT = "vlog_tpu", "vlog_tpu_torch"
TIMEOUT_S = 90.0
MEDIA_HEADERS = ("ETag", "Last-Modified", "Content-Type", "Content-Length",
                 "Content-Range", "Cache-Control", "Accept-Ranges",
                 "Retry-After", "Access-Control-Allow-Origin",
                 "Access-Control-Allow-Methods",
                 "Access-Control-Allow-Headers",
                 "Access-Control-Expose-Headers", "Access-Control-Max-Age")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def fresh_registries(monkeypatch):
    for pkg in (JAX, PORT):
        monkeypatch.setattr(_mod(pkg, "delivery.plane"), "_PLANES",
                            weakref.WeakSet())


# --------------------------------------------------------------------------
# the site: one database, one tree
# --------------------------------------------------------------------------

async def _build_site(root: Path) -> dict:
    from vlog_tpu_torch.db import Database, create_all
    from vlog_tpu_torch.jobs import videos as vids
    from vlog_tpu_torch.worker.pipeline import process_video

    videos = root / "videos"
    src = make_y4m(root / "src.y4m", n_frames=24, width=128, height=96,
                   fps=24, seed=3)
    db = Database(f"sqlite:///{root / 'site.db'}")
    await db.connect()
    await create_all(db)
    slugs = {}
    try:
        main = await vids.create_video(db, "Port Clip",
                                       description="made on the CPU")
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            result = await asyncio.to_thread(
                process_video, src, videos / main["slug"], device="cpu")
        finally:
            torch.set_num_threads(n)
        qualities = [dict(q, playlist_path=f"{q['quality']}/playlist.m3u8")
                     for q in result.to_db_rows()]
        await db.execute(
            "UPDATE videos SET category='demo', tags=:t WHERE id=:i",
            {"t": json.dumps(["cpu", "port"]), "i": main["id"]})
        await vids.finalize_ready(db, main["id"], probe=result.source,
                                  qualities=qualities,
                                  thumbnail_path="thumbnail.jpg")
        slugs["main"] = main["slug"]
        # a second ready video (its own copy of the tree), a pending one
        # whose tree exists, and a deleted one
        for key, title, status in (("other", "Second Clip", "ready"),
                                   ("pending", "Not Yet", "pending"),
                                   ("deleted", "Gone", "ready")):
            v = await vids.create_video(db, title)
            shutil.copytree(videos / main["slug"], videos / v["slug"])
            await db.execute(
                "UPDATE videos SET status=:s, category='demo', tags=:t, "
                "thumbnail_path='thumbnail.jpg', "
                "deleted_at=CASE WHEN :d THEN 1800000000.0 END "
                "WHERE id=:i",
                {"s": status, "t": json.dumps(["port", key]),
                 "d": key == "deleted", "i": v["id"]})
            slugs[key] = v["slug"]
        t = 1_800_000_000.0
        for start, title in ((0.0, "Intro"), (1.0, "Middle")):
            await db.execute(
                "INSERT INTO chapters (video_id, start_s, title, created_at) "
                "VALUES (:v, :s, :t, :c)",
                {"v": main["id"], "s": start, "t": title, "c": t})
        await db.execute(
            "INSERT INTO transcriptions (video_id, language, model, "
            "vtt_path, full_text, status, created_at, completed_at) "
            "VALUES (:v, 'en', 'tiny', 'captions.vtt', 'hello there', "
            "'completed', :t, :t)", {"v": main["id"], "t": t})
        for i, (pslug, vis) in enumerate((("mix", "public"),
                                          ("hidden", "unlisted"),
                                          ("mine", "private"))):
            pid = await db.execute(
                "INSERT INTO playlists (slug, title, description, "
                "visibility, created_at, updated_at) "
                "VALUES (:s, :ti, 'd', :v, :t, :u)",
                {"s": pslug, "ti": pslug.title(), "v": vis, "t": t,
                 "u": t + i})
            for pos, key in enumerate(("main", "other", "deleted")):
                vid = await vids.get_video_by_slug(db, slugs[key])
                await db.execute(
                    "INSERT INTO playlist_items (playlist_id, video_id, "
                    "position, added_at) VALUES (:p, :v, :pos, :t)",
                    {"p": pid, "v": vid["id"], "pos": pos, "t": t})
        from vlog_tpu_torch.api.settings import SettingsService

        svc = SettingsService(db)
        await svc.set("display.site_title", "port site")
        await svc.set("display.watermark.enabled", True)
    finally:
        await db.disconnect()
    manifest = json.loads((videos / slugs["main"] / "outputs.json"
                           ).read_text())
    return {"root": root, "videos": videos, "db_url":
            f"sqlite:///{root / 'site.db'}", "slugs": slugs,
            "files": sorted(manifest["files"] if "files" in manifest
                            else manifest)}


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(
            _build_site(tmp_path_factory.mktemp("site")), 300.0))
    finally:
        loop.close()


class Apps:
    """Both packages' public apps on the site, each behind a loopback
    test server, each on its own ``Database`` over the one file."""

    def __init__(self, site: dict, ports: dict | None = None):
        self.site, self.ports = site, ports or {}
        self.db, self.app, self.client = {}, {}, {}

    async def __aenter__(self) -> "Apps":
        for pkg in (JAX, PORT):
            db = _mod(pkg, "db").Database(self.site["db_url"])
            await db.connect()
            self.db[pkg] = db
            self.app[pkg] = _mod(pkg, "api.public_api").build_public_app(
                db, video_dir=self.site["videos"])
            server = TestServer(self.app[pkg], port=self.ports.get(pkg))
            self.client[pkg] = TestClient(server)
            await self.client[pkg].start_server()
        return self

    async def __aexit__(self, *exc) -> None:
        for pkg in (JAX, PORT):
            if pkg in self.client:
                await self.client[pkg].close()
            if pkg in self.db:
                await self.db[pkg].disconnect()

    def plane(self, pkg: str):
        return self.app[pkg][_mod(pkg, "api.public_api").DELIVERY]

    async def both(self, method: str, url: str, **kw) -> dict:
        out = {}
        for pkg in (JAX, PORT):
            r = await self.client[pkg].request(method, url, **kw)
            out[pkg] = (r.status, await r.read(),
                        {h: r.headers.get(h) for h in MEDIA_HEADERS})
        return out


def _serve(site: dict, body, ports: dict | None = None,
           timeout: float = TIMEOUT_S):
    async def go():
        async with Apps(site, ports) as apps:
            return await body(apps)

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(go(), timeout))
    finally:
        loop.close()


# --------------------------------------------------------------------------
# routes and JSON
# --------------------------------------------------------------------------

def test_route_tables_are_equal(site):
    def table(app):
        return sorted((r.method, r.resource.canonical)
                      for r in app.router.routes())

    async def body(apps):
        return {pkg: table(apps.app[pkg]) for pkg in (JAX, PORT)}

    got = _serve(site, body)
    assert got[PORT] == got[JAX]
    api = [(m, path) for m, path in got[PORT] if m != "HEAD"
           and path != "/" and not path.startswith("/ui/")]
    assert len(api) == 18       # and the UI's two, and HEAD beside GET


def _mask(obj, token_keys=("session",)):
    if isinstance(obj, dict):
        return {k: ("<masked>" if k in token_keys else _mask(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _json_or_text(body: bytes):
    try:
        return json.loads(body)
    except ValueError:          # a framework 400 answers in plain text
        return body.decode()


def test_json_routes_answer_alike(site):
    s = site["slugs"]
    urls = [
        "/api/videos", "/api/videos?limit=1", "/api/videos?limit=2&offset=1",
        "/api/videos?q=Clip", "/api/videos?category=demo",
        "/api/videos?limit=x", f"/api/videos/{s['main']}",
        f"/api/videos/{s['pending']}", f"/api/videos/{s['deleted']}",
        "/api/videos/no-such", f"/api/videos/{s['main']}/transcript",
        f"/api/videos/{s['other']}/transcript",
        f"/api/videos/{s['main']}/related",
        f"/api/videos/{s['main']}/related?limit=1", "/api/categories",
        "/api/tags", "/api/tags/port/videos", "/api/tags/cpu/videos?limit=1",
        "/api/playlists", "/api/playlists/mix", "/api/playlists/hidden",
        "/api/playlists/mine", "/api/config", "/api/delivery/gossip",
        "/healthz", "/api/videos?cursor=garbage",
    ]

    async def body(apps):
        out = {}
        for url in urls:
            got = await apps.both("GET", url)
            out[url] = {pkg: (st, _json_or_text(b)) for pkg, (st, b, _)
                        in got.items()}
        first = out["/api/videos?limit=1"][PORT][1]
        nxt = f"/api/videos?limit=1&cursor={first['next_cursor']}"
        got = await apps.both("GET", nxt)
        out[nxt] = {pkg: (st, _json_or_text(b)) for pkg, (st, b, _)
                    in got.items()}
        for url in ("/", "/ui/app.js", "/ui/player.js", "/ui/style.css",
                    "/ui/nope.js", "/metrics"):
            got = await apps.both("GET", url)
            out[url] = {pkg: (st, b if url != "/metrics" else
                              b"vlog_delivery_requests_total" in b,
                              h["Content-Type"])
                        for pkg, (st, b, h) in got.items()}
        return out

    out = _serve(site, body)
    for url, got in out.items():
        assert got[PORT] == got[JAX], url
    assert out["/api/videos"][PORT][1]["total"] == 2
    assert out[f"/api/videos/{s['pending']}"][PORT][0] == 404
    assert out["/api/videos?limit=x"][PORT][0] == 400
    assert out[f"/api/videos/{s['main']}"][PORT][1]["video"]["qualities"]
    assert out["/api/config"][PORT][1]["site_title"] == "port site"
    assert out["/metrics"][PORT][:2] == (200, True)


def test_session_routes_leave_equal_rows(site):
    s = site["slugs"]

    async def body(apps):
        out = {}
        for pkg in (JAX, PORT):
            c = apps.client[pkg]
            steps = []
            r = await c.post(f"/api/videos/{s['other']}/session")
            tok = (await r.json())["session"]
            steps.append((r.status, _mask(await r.json())))
            for path, js in (("/api/sessions/heartbeat",
                              {"session": tok, "watch_time_s": 12.5}),
                             ("/api/sessions/end",
                              {"session": tok, "watch_time_s": 3.0}),
                             ("/api/sessions/end", {"session": tok}),
                             ("/api/sessions/heartbeat",
                              {"session": "nope"})):
                r = await c.post(path, json=js)
                steps.append((r.status, await r.json()))
            r = await c.post("/api/videos/no-such/session")
            steps.append((r.status, await r.json()))
            row = await apps.db[pkg].fetch_one(
                "SELECT * FROM playback_sessions WHERE session_token=:t",
                {"t": tok})
            out[pkg] = (steps, row)
        return out

    out = _serve(site, body)
    (ref_steps, ref_row), (port_steps, port_row) = out[JAX], out[PORT]
    assert port_steps == ref_steps
    masked = ("id", "session_token", "started_at", "last_heartbeat_at",
              "ended_at")
    assert {k: v for k, v in port_row.items() if k not in masked} == \
        {k: v for k, v in ref_row.items() if k not in masked}
    assert port_row["watch_time_s"] == 12.5 and port_row["ended_at"]


# --------------------------------------------------------------------------
# media
# --------------------------------------------------------------------------

def _conditional_matrix(etag: str, lastmod: str) -> list[dict]:
    return [
        {}, {"Range": "bytes=0-99"}, {"Range": "bytes=100-"},
        {"Range": "bytes=-50"}, {"Range": "bytes=0-0,5-9"},
        {"Range": "bytes=999999-"}, {"Range": "items=0-1"},
        {"If-None-Match": etag}, {"If-None-Match": f"W/{etag}"},
        {"If-None-Match": f'"x", {etag}'}, {"If-None-Match": '"nope"'},
        {"If-None-Match": "*"},
        {"If-Range": etag, "Range": "bytes=0-99"},
        {"If-Range": '"stale"', "Range": "bytes=0-99"},
        {"If-Range": lastmod, "Range": "bytes=0-99"},
        {"If-Modified-Since": lastmod},
    ]


@pytest.mark.parametrize("path", ["ram", "sendfile"])
def test_media_requests_answer_alike(path, site, monkeypatch):
    """Every file of ``outputs.json`` by GET and HEAD, a segment and a
    playlist through the conditional matrix, OPTIONS, the downloads gate,
    a tree that is not ready, a traversal (the server normalizes it away
    from the media route) and a path too deep. ``sendfile``: every object
    over 1 KiB takes the large-object bypass (``FileEntry``)."""
    if path == "sendfile":
        for pkg in (JAX, PORT):
            monkeypatch.setattr(_mod(pkg, "config"),
                                "DELIVERY_MAX_ENTRY_BYTES", 1024)
    s = site["slugs"]
    base = f"/videos/{s['main']}"
    disk = site["videos"] / s["main"]

    async def body(apps):
        seen = []

        def check(url, got, want=None):
            assert got[PORT] == got[JAX], (url, got[PORT][0], got[JAX][0])
            if want is not None:
                assert got[PORT][0] == want, (url, got[PORT][0])
            seen.append(got[PORT][0])

        for rel in site["files"]:
            url = f"{base}/{rel}"
            want = 403 if rel.startswith("original") else 200
            get = await apps.both("GET", url)
            check(url, get, want)
            check(url, await apps.both("HEAD", url), want)
            if want == 200:
                st, b, h = get[PORT]
                assert b == (disk / rel).read_bytes(), rel
                assert h["Content-Length"] == str(len(b))
        for rel in ("360p/segment_00001.m4s", "360p/playlist.m3u8"):
            url = f"{base}/{rel}"
            first = await apps.both("GET", url)
            etag, lastmod = (first[PORT][2]["ETag"],
                             first[PORT][2]["Last-Modified"])
            for headers in _conditional_matrix(etag, lastmod):
                check((url, headers), await apps.both("GET", url,
                                                      headers=headers))
            check(url, await apps.both(
                "OPTIONS", url,
                headers={"Origin": "https://player.example",
                         "Access-Control-Request-Method": "GET"}), 204)
        for url, want in ((f"/videos/{s['pending']}/master.m3u8", 404),
                          (f"/videos/{s['deleted']}/master.m3u8", 404),
                          ("/videos/no-such/master.m3u8", 404),
                          (f"{base}/360p/segment_09999.m4s", 404),
                          (f"{base}/360p/%2e%2e/%2e%2e/site.db", 404),
                          (f"{base}/a/b/c/d/e.m4s", 400)):
            check(url, await apps.both("GET", url), want)
        return seen

    for pkg in (JAX, PORT):
        monkeypatch.setattr(_mod(pkg, "config"), "DOWNLOADS_ENABLED", False)
    seen = _serve(site, body)
    assert {200, 206, 304, 403, 404, 416, 204, 400} <= set(seen)
    # with downloads enabled the source serves, alike
    for pkg in (JAX, PORT):
        monkeypatch.setattr(_mod(pkg, "config"), "DOWNLOADS_ENABLED", True)

    async def originals(apps):
        got = await apps.both("GET", f"{base}/original.y4m",
                              headers={"Range": "bytes=10-19"})
        assert got[PORT] == got[JAX]
        return got[PORT]

    st, b, _ = _serve(site, originals)
    assert st == 206 and b == (disk / "original.y4m").read_bytes()[10:20]


def test_steady_state_hit_takes_zero_queries_and_zero_opens(site,
                                                            monkeypatch):
    url = f"/videos/{site['slugs']['main']}/360p/segment_00001.m4s"

    async def body(apps):
        client, plane, db = (apps.client[PORT], apps.plane(PORT),
                             apps.db[PORT])
        r = await client.get(url)
        want = await r.read()
        assert r.status == 200 and plane.counters["disk_reads"] == 1
        opened = []
        real_open = Path.open
        monkeypatch.setattr(Path, "open", lambda self, *a, **k: (
            opened.append(self), real_open(self, *a, **k))[1])
        q0, hits0 = db.query_count, plane.counters["hits"]
        for _ in range(5):
            r = await client.get(url)
            assert await r.read() == want
        monkeypatch.undo()
        return (db.query_count - q0, opened, plane.counters["disk_reads"],
                plane.counters["hits"] - hits0)

    assert _serve(site, body) == (0, [], 1, 5)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_ring_of_two_fills_across_packages(site, monkeypatch):
    """Origin A (the JAX package's app) and origin B (the port's) on one
    ring of two (``VLOG_DELIVERY_PEERS`` and ``VLOG_DELIVERY_SELF_URL``
    of each package's config): a request for an immutable object the
    other origin owns is filled from it over loopback, in both
    directions, and every body equals the file on disk."""
    s = site["slugs"]
    disk = site["videos"] / s["main"]
    rels = [r for r in site["files"] if not r.startswith("original")]
    mutable = _mod(PORT, "delivery.http").MUTABLE_SUFFIXES
    Ring = _mod(PORT, "delivery.ring").Ring
    for _ in range(100):    # ports whose ring gives each origin a key
        ports = {JAX: _free_port(), PORT: _free_port()}
        urls = {pkg: f"http://127.0.0.1:{p}" for pkg, p in ports.items()}
        ring = (urls[JAX], urls[PORT])
        owned = {pkg: sum(Ring(ring, urls[pkg]).is_local(f"{s['main']}/{rel}")
                          for rel in rels if not rel.endswith(mutable))
                 for pkg in (JAX, PORT)}
        if ports[JAX] != ports[PORT] and min(owned.values()) > 0:
            break
    else:
        pytest.fail("no pair of ports split the keys")
    for pkg in (JAX, PORT):
        cfg = _mod(pkg, "config")
        monkeypatch.setattr(cfg, "DELIVERY_PEERS", ring)
        monkeypatch.setattr(cfg, "DELIVERY_SELF_URL", urls[pkg])
        monkeypatch.setattr(cfg, "DELIVERY_GOSSIP_INTERVAL_S", 0.0)

    async def body(apps):
        for pkg in (JAX, PORT):
            for rel in rels:
                r = await apps.client[pkg].get(f"/videos/{s['main']}/{rel}")
                assert r.status == 200, rel
                assert await r.read() == (disk / rel).read_bytes(), rel
        return {pkg: dict(apps.plane(pkg).counters) for pkg in (JAX, PORT)}

    counters = _serve(site, body, ports)
    for pkg, other in ((JAX, PORT), (PORT, JAX)):
        assert counters[pkg]["peer_errors"] == 0
        assert counters[pkg]["peer_fills"] == owned[other] > 0


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_finalize_ready_evicts_and_prewarms(pkg, site):
    """A republish through the package's ``finalize_ready`` drops the
    slug from its serving plane and prewarms the init segment and the
    leading segments; the next viewer hits RAM."""
    s = site["slugs"]
    seg = f"/videos/{s['other']}/360p/segment_00001.m4s"

    async def body(apps):
        plane, db = apps.plane(pkg), apps.db[pkg]
        vids = _mod(pkg, "jobs.videos")
        r = await apps.client[pkg].get(seg)
        assert r.status == 200
        reads0 = plane.counters["disk_reads"]
        row = await vids.get_video_by_slug(db, s["other"])
        from types import SimpleNamespace

        await vids.finalize_ready(
            db, row["id"], probe=SimpleNamespace(
                duration_s=row["duration_s"], width=row["width"],
                height=row["height"], fps=row["fps"]),
            qualities=[], thumbnail_path=row["thumbnail_path"])
        for _ in range(50):
            if not plane._tasks:
                break
            await asyncio.gather(*list(plane._tasks),
                                 return_exceptions=True)
        warmed = plane.counters["disk_reads"] - reads0
        r = await apps.client[pkg].get(seg)
        assert r.status == 200
        return (plane.counters["invalidations"],
                plane.counters["prewarm_runs"],
                plane.counters["prewarm_segments"], warmed,
                plane.counters["disk_reads"] - reads0)

    inval, runs, segs, warmed, reads = _serve(site, body)
    assert (inval, runs) == (1, 1)
    assert segs == warmed == reads == 2     # init + the one segment
    with sqlite3.connect(site["root"] / "site.db") as con:
        assert con.execute("SELECT status FROM videos WHERE slug=?",
                           (s["other"],)).fetchone() == ("ready",)
