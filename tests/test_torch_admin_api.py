"""The port's admin API (``vlog_tpu_torch.api.admin_api``, with
``api/catalog.py`` mounted) against the JAX package's.

The site is ``tests/test_torch_public_api.py``'s (a 96x128 Y4M through
the port's ``process_video`` on the CPU, published; ready, pending and
deleted videos, chapters, a transcript, playlists, settings) plus the
admin plane's rows: a claimed transcode with progress, a dead-lettered
re-encode with its failure history, a completed sprite job, two workers
(one with an API key), a webhook with a delivery, a worker command,
playback sessions across months, a custom field, a sprite sheet.

- Both apps register the same route table (the catalog's included).
- On one database and tree every JSON route answers both apps alike
  (timestamps, tokens and free-space figures masked; the process-wide
  GC, delivery and SLO snapshots by their keys).
- The mutating routes, sent in one sequence to each app on its own copy
  of the site, answer alike and leave equal rows, trees and audit lines.
- An upload through each app leaves equal ``videos``/``jobs`` rows and
  equal stored bytes; both answer 413 past the same size.
- Auth with and without ``VLOG_ADMIN_SECRET``, the cookie session with
  its CSRF token, and the login throttle behave alike.
- The SSE progress stream sends both apps' clients the same events.
- The admin UI's assets are byte copies of the reference's and served
  alike.

Every test that starts a server runs under an ``asyncio.timeout``.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import re
import shutil
import sqlite3
import weakref
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

from tests.fixtures.media import make_y4m
from tests.test_torch_public_api import _build_site

JAX, PORT = "vlog_tpu", "vlog_tpu_torch"
PKGS = (JAX, PORT)
TIMEOUT_S = 120.0
TIME_KEYS = ("ts", "expires_in_s")
SECRET_KEYS = ("csrf_token", "token_hash", "key_hash", "key_prefix",
               "session_token", "trace_id", "span_id", "parent_id")
# process-wide snapshots: compared by their keys
SNAPSHOT_URLS = ("/api/storage/gc", "/api/delivery/stats", "/api/slo")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch):
    """Each test starts with no delivery plane and no login failures in
    either package's process state."""
    for pkg in PKGS:
        monkeypatch.setattr(_mod(pkg, "delivery.plane"), "_PLANES",
                            weakref.WeakSet())
        monkeypatch.setattr(_mod(pkg, "api.admin_api"), "_LOGIN_FAILS", {})


def run_async(body, timeout: float = TIMEOUT_S):
    async def go():
        async with asyncio.timeout(timeout):
            return await body()

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(go())
    finally:
        loop.close()


# --------------------------------------------------------------------------
# the site
# --------------------------------------------------------------------------

async def _build_admin_site(root: Path) -> dict:
    from vlog_tpu_torch.api import auth
    from vlog_tpu_torch.db import Database
    from vlog_tpu_torch.db.core import now as db_now
    from vlog_tpu_torch.enums import AcceleratorKind, JobKind
    from vlog_tpu_torch.jobs import claims, commands, videos as vids

    site = await _build_site(root)
    db = Database(site["db_url"])
    await db.connect()
    t = db_now()
    ids = {}
    try:
        for key, slug in site["slugs"].items():
            ids[key] = (await vids.get_video_by_slug(db, slug))["id"]
        await db.execute("UPDATE videos SET source_path=:p WHERE id=:i",
                         {"p": str(root / "src.y4m"), "i": ids["main"]})
        tpu = AcceleratorKind.TPU
        jobs = {"claimed": await claims.enqueue_job(db, ids["pending"])}
        await claims.claim_job(db, "w1", accelerator=tpu)
        await claims.update_progress(db, jobs["claimed"], "w1",
                                     progress=33.0, current_step="ladder")
        jobs["dead"] = await claims.enqueue_job(
            db, ids["main"], JobKind.REENCODE,
            payload={"streaming_format": "cmaf", "codec": "h265"})
        await claims.claim_job(db, "w2", kinds=(JobKind.REENCODE,),
                               accelerator=tpu)
        await claims.fail_job(db, jobs["dead"], "w2", "encoder exploded",
                              permanent=True)
        jobs["done"] = await claims.enqueue_job(db, ids["other"],
                                                JobKind.SPRITE)
        await claims.claim_job(db, "w1", kinds=(JobKind.SPRITE,),
                               accelerator=tpu)
        await claims.complete_job(db, jobs["done"], "w1")
        for name, seen in (("w1", t), ("w2", t - 86400.0)):
            await db.execute(
                "INSERT INTO workers (name, kind, accelerator, capabilities,"
                " code_version, last_heartbeat_at, status, created_at) "
                "VALUES (:n, 'local', 'tpu', :c, '1.0', :h, 'active', :t)",
                {"n": name, "c": json.dumps({"backend": "torch"}),
                 "h": seen, "t": t - 90000.0})
        await auth.create_worker_key(db, "w2")
        hook = await db.execute(
            "INSERT INTO webhooks (url, secret, events, active, created_at) "
            "VALUES ('https://hooks.example.invalid/a', 's', :e, 1, :t)",
            {"e": json.dumps(["video.ready"]), "t": t})
        await db.execute(
            "INSERT INTO webhook_deliveries (webhook_id, event, payload, "
            "status, attempts, response_code, created_at, next_attempt_at)"
            " VALUES (:w, 'video.ready', '{}', 'failed', 3, 500, :t, :t)",
            {"w": hook, "t": t})
        await commands.send_command(db, "w1", "stats", {})
        for i, (age_days, ended) in enumerate(((1, True), (40, True),
                                               (400, False), (0, False))):
            start = t - age_days * 86400.0 - 600.0
            await db.execute(
                "INSERT INTO playback_sessions (video_id, session_token, "
                "started_at, last_heartbeat_at, ended_at, watch_time_s) "
                "VALUES (:v, :k, :s, :h, :e, :w)",
                {"v": ids["main"], "k": f"tok{i}", "s": start,
                 "h": start + 300.0, "e": start + 300.0 if ended else None,
                 "w": 100.0 + i})
        field = await db.execute(
            "INSERT INTO custom_fields (name, label, field_type, required, "
            "options, position, created_at) VALUES ('director', "
            "'Director', 'text', 0, '[]', 0, :t)", {"t": t})
        await db.execute(
            "INSERT INTO video_custom_values (video_id, field_id, value, "
            "updated_at) VALUES (:v, :f, :val, :t)",
            {"v": ids["main"], "f": field, "val": json.dumps("Ada"),
             "t": t})
    finally:
        await db.disconnect()
    tree = site["videos"] / site["slugs"]["main"]
    (tree / "sprites").mkdir(exist_ok=True)
    shutil.copy(tree / "thumbnail.jpg", tree / "sprites" / "sheet_0001.jpg")
    (tree / "sprites" / "sprites.vtt").write_text(
        "WEBVTT\n\n00:00:00.000 --> 00:00:00.500\n"
        "sheet_0001.jpg#xywh=0,0,64,48\n\n00:00:00.500 --> 00:00:01.000\n"
        "sheet_0001.jpg#xywh=64,0,64,48\n")
    (site["root"] / "uploads").mkdir(exist_ok=True)
    return site | {"ids": ids, "jobs": jobs, "hook": hook, "field": field}


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    async def body():
        return await _build_admin_site(tmp_path_factory.mktemp("admin"))

    return run_async(body, 300.0)


def copy_site(site: dict, dest: Path) -> dict:
    """The site's database and trees, copied under ``dest`` (the source
    paths in the copy's rows point into the copy)."""
    shutil.copytree(site["root"], dest)
    con = sqlite3.connect(dest / "site.db")
    try:
        con.execute("UPDATE videos SET source_path=replace(source_path, ?, ?)",
                    (str(site["root"]), str(dest)))
        con.commit()
    finally:
        con.close()
    return site | {"root": dest, "videos": dest / "videos",
                   "db_url": f"sqlite:///{dest / 'site.db'}"}


# --------------------------------------------------------------------------
# both apps
# --------------------------------------------------------------------------

class Admins:
    """Both packages' admin apps behind loopback test servers: on one
    site, or each on its own (``sites``), each on its own ``Database``;
    the port's on ``device="cpu"``."""

    def __init__(self, sites: dict, audit: dict | None = None):
        self.sites, self.audit = sites, audit or {}
        self.db, self.app, self.client = {}, {}, {}

    async def __aenter__(self) -> "Admins":
        for pkg in PKGS:
            site = self.sites[pkg]
            db = _mod(pkg, "db").Database(site["db_url"])
            await db.connect()
            self.db[pkg] = db
            kw = dict(upload_dir=site["root"] / "uploads",
                      video_dir=site["videos"],
                      audit_path=self.audit.get(pkg))
            if pkg == PORT:
                kw["device"] = "cpu"
            self.app[pkg] = _mod(pkg, "api.admin_api").build_admin_app(
                db, **kw)
            self.client[pkg] = TestClient(TestServer(self.app[pkg]))
            await self.client[pkg].start_server()
        return self

    async def __aexit__(self, *exc) -> None:
        for pkg in PKGS:
            if pkg in self.client:
                await self.client[pkg].close()
            if pkg in self.db:
                await self.db[pkg].disconnect()

    async def both(self, method: str, url: str, **kw) -> dict:
        out = {}
        for pkg in PKGS:
            r = await self.client[pkg].request(method, url, **kw)
            out[pkg] = (r.status, await r.read(),
                        r.headers.get("Content-Type", "").split(";")[0])
        return out


def serve(sites: dict, body, audit: dict | None = None):
    async def go():
        async with Admins(sites, audit) as apps:
            return await body(apps)

    return run_async(go)


def norm(obj, roots=()):
    """Timestamps, tokens and site paths masked."""
    if isinstance(obj, dict):
        # a span's and a GC sweep's duration are measured, not stored
        timed = TIME_KEYS + (("duration_s",) if "span_id" in obj
                             or "scanned" in obj else ())
        return {k: ("<time>" if k.endswith("_at") or k in timed
                    else "<secret>" if k in SECRET_KEYS else norm(v, roots))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [norm(v, roots) for v in obj]
    if isinstance(obj, str):
        for r in roots:
            obj = obj.replace(str(r), "<root>")
        return re.sub(r"\.upload-[0-9a-f]{32}", ".upload-<uuid>", obj)
    return obj


def decoded(body: bytes, ctype: str, roots=()):
    if ctype == "application/json":
        return norm(json.loads(body), roots)
    return body


def routes(app) -> list:
    return sorted((r.method, r.resource.canonical)
                  for r in app.router.routes())


# --------------------------------------------------------------------------
# routes and JSON
# --------------------------------------------------------------------------

def test_route_tables_are_equal(site):
    async def body(apps):
        return {pkg: routes(apps.app[pkg]) for pkg in PKGS}

    got = serve({JAX: site, PORT: site}, body)
    assert got[PORT] == got[JAX]
    api = {(m, p) for m, p in got[PORT] if m != "HEAD"}
    assert ("POST", "/api/videos/{video_id}/thumbnail/from-time") in api
    assert ("GET", "/api/events/progress") in api
    assert len(api) >= 70


def json_urls(site: dict) -> list[str]:
    i, j = site["ids"], site["jobs"]
    return [
        "/api/videos", "/api/videos?limit=1", "/api/videos?limit=2&offset=1",
        "/api/videos?status=ready", "/api/videos?q=Clip", "/api/videos?q=%25",
        "/api/videos?include_deleted=1", "/api/videos?cursor=garbage",
        "/api/videos?limit=x", *(f"/api/videos/{v}" for v in i.values()),
        "/api/videos/999", "/api/videos/99999999999999999999",
        "/api/jobs", "/api/jobs?state=claimed", "/api/jobs?state=failed",
        "/api/jobs?tenant=default", "/api/jobs?limit=1",
        f"/api/jobs?limit=1&cursor={j['dead']}", "/api/jobs/failed",
        f"/api/jobs/{j['dead']}/failures", "/api/jobs/999/failures",
        f"/api/jobs/{j['claimed']}/trace", f"/api/jobs/{j['done']}/trace",
        "/api/audit", "/api/analytics/daily", "/api/analytics/daily?days=400",
        "/api/storage/status", "/api/settings", "/api/webhooks",
        f"/api/webhooks/{site['hook']}/deliveries",
        "/api/webhooks/99/deliveries", "/api/workers",
        "/api/fleet/scale-hint", "/api/workers/w1/commands",
        f"/api/videos/{i['main']}/chapters", "/api/analytics/summary",
        "/api/analytics/sessions/months",
        "/api/analytics/sessions/months?months=2", "/api/auth/session",
        "/healthz", "/api/playlists", "/api/playlists/1", "/api/playlists/3",
        "/api/playlists/999", "/api/custom-fields",
        f"/api/videos/{i['main']}/custom-fields",
        f"/api/videos/{i['main']}/transcript",
        f"/api/videos/{i['other']}/transcript",
        f"/api/videos/{i['main']}/sprites",
        f"/api/videos/{i['other']}/sprites",
        f"/api/videos/{i['main']}/sprites/sheet_0001.jpg",
        f"/api/videos/{i['main']}/sprites/..%2Fthumbnail.jpg",
        f"/api/videos/{i['main']}/thumbnail", "/api/videos/999/thumbnail",
        *SNAPSHOT_URLS,
    ]


def test_json_routes_answer_alike(site):
    urls = json_urls(site)

    async def body(apps):
        out = {}
        for url in urls:
            got = await apps.both("GET", url)
            out[url] = {pkg: (st, ct, decoded(b, ct, (site["root"],)))
                        for pkg, (st, b, ct) in got.items()}
        return out

    out = serve({JAX: site, PORT: site}, body)
    for url, got in out.items():
        if url in SNAPSHOT_URLS:
            assert got[PORT][:2] == got[JAX][:2] == (200, "application/json")
            assert sorted(got[PORT][2]) == sorted(got[JAX][2]), url
            continue
        if url == "/api/storage/status":
            for pkg in PKGS:
                for vol in got[pkg][2]["volumes"].values():
                    vol["free_bytes"] = "<free>"
        assert got[PORT] == got[JAX], url
    assert out["/api/videos"][PORT][2]["total"] == 3
    assert out["/api/jobs?state=claimed"][PORT][2]["jobs"][0]["progress"] \
        == 33.0
    assert out["/api/jobs/failed"][PORT][2]["jobs"][0]["failures"]
    assert out[f"/api/videos/{site['ids']['main']}/sprites"][PORT][0] == 200
    assert out["/api/videos/99999999999999999999"][PORT][0] == 404
    assert out["/api/videos?limit=x"][PORT][0] == 400


# --------------------------------------------------------------------------
# mutations, each app on its own copy
# --------------------------------------------------------------------------

def mutation_steps(site: dict) -> list[tuple]:
    i, j = site["ids"], site["jobs"]
    jpeg = (site["videos"] / site["slugs"]["main"] / "thumbnail.jpg"
            ).read_bytes()
    return [
        ("POST", f"/api/videos/{i['pending']}/retranscode", {}),
        ("POST", f"/api/videos/{i['other']}/retranscode", {"force": True}),
        ("POST", "/api/videos/999/retranscode", {}),
        ("POST", f"/api/videos/{i['other']}/reencode",
         {"codec": "av1", "streaming_format": "cmaf"}),
        ("POST", f"/api/videos/{i['main']}/reencode", {"codec": "h265"}),
        ("POST", f"/api/videos/{i['main']}/reencode",
         {"codec": "h265", "force": True}),
        ("POST", f"/api/videos/{i['main']}/reencode",
         {"codec": "av1", "streaming_format": "hls_ts"}),
        ("POST", f"/api/videos/{i['other']}/reencode",
         {"streaming_format": "dash"}),
        ("POST", f"/api/videos/{i['main']}/manifests/regenerate", None),
        ("POST", f"/api/videos/{i['main']}/verify", None),
        ("POST", f"/api/jobs/{j['dead']}/requeue", None),
        ("POST", f"/api/jobs/{j['claimed']}/requeue", None),
        ("DELETE", f"/api/videos/{i['other']}", None),
        ("POST", f"/api/videos/{i['other']}/restore", None),
        ("POST", f"/api/videos/{i['main']}/restore", None),
        ("POST", "/api/storage/gc", {"dry_run": True}),
        ("POST", "/api/storage/gc", {"temp_max_age_s": "x"}),
        ("POST", "/api/delivery/invalidate", {"slug": site["slugs"]["main"]}),
        ("POST", "/api/delivery/invalidate", {"all": True}),
        ("POST", "/api/delivery/invalidate", {}),
        ("PUT", "/api/settings/site.motd", {"value": "hello"}),
        ("PUT", "/api/settings/limits.max", {"value": 3, "type": "int"}),
        ("PUT", "/api/settings/a..b", {"value": 1}),
        ("DELETE", "/api/settings/display.site_title", None),
        ("DELETE", "/api/settings/no.such", None),
        ("POST", "/api/webhooks", {"url": "https://hooks.example.invalid/b",
                                   "events": ["video.ready"]}),
        ("POST", "/api/webhooks", {"url": "http://127.0.0.1/x"}),
        ("DELETE", f"/api/webhooks/{site['hook']}", None),
        ("POST", "/api/workers/w1/drain", None),
        ("POST", "/api/workers/w1/profile", {"duration_s": 5}),
        ("POST", "/api/workers/w1/command", {"command": "ping"}),
        ("POST", "/api/workers/w1/command", {"command": "nope"}),
        ("POST", "/api/workers/w2/revoke", None),
        ("PUT", f"/api/videos/{i['main']}/chapters",
         {"chapters": [{"title": "Start", "start_s": 0},
                       {"title": "End", "start_s": 0.5}]}),
        ("PUT", f"/api/videos/{i['main']}/chapters",
         {"chapters": [{"title": 3, "start_s": 0}]}),
        ("POST", f"/api/videos/{i['main']}/chapters/detect", None),
        ("POST", "/api/analytics/sessions/prune", None),
        ("POST", "/api/playlists", {"title": "New List",
                                    "visibility": "unlisted"}),
        ("POST", "/api/playlists", {"title": ""}),
        ("PATCH", "/api/playlists/1", {"title": "Mix Two"}),
        ("POST", "/api/playlists/2/videos", {"video_id": i["pending"]}),
        ("POST", "/api/playlists/2/videos", {"video_id": i["pending"]}),
        ("DELETE", f"/api/playlists/1/videos/{i['main']}", None),
        ("PUT", "/api/playlists/1/order",
         {"video_ids": [i["deleted"], i["other"]]}),
        ("DELETE", "/api/playlists/3", None),
        ("POST", "/api/custom-fields",
         {"name": "mood", "field_type": "select",
          "options": ["calm", "loud"]}),
        ("POST", "/api/custom-fields", {"name": "Bad Name"}),
        ("PUT", f"/api/videos/{i['main']}/custom-fields",
         {"director": "Grace", "mood": "calm"}),
        ("PUT", f"/api/videos/{i['main']}/custom-fields", {"mood": "x"}),
        ("DELETE", f"/api/custom-fields/{site['field']}", None),
        ("PUT", f"/api/videos/{i['main']}/thumbnail", jpeg),
        ("PUT", f"/api/videos/{i['main']}/thumbnail", b"not a jpeg"),
        ("PUT", f"/api/videos/{i['other']}/transcript",
         {"text": "fixed", "vtt": "WEBVTT\n\n00:00.000 --> 00:01.000\nhi\n",
          "language": "en"}),
        ("PUT", f"/api/videos/{i['other']}/transcript", {"text": ""}),
        ("DELETE", f"/api/videos/{i['main']}/transcript", None),
        ("POST", "/api/videos/bulk", {"action": "set_category",
                                      "category": "misc",
                                      "video_ids": [i["main"], i["other"]]}),
        ("POST", "/api/videos/bulk", {"action": "delete",
                                      "video_ids": [i["pending"], 999]}),
        ("POST", "/api/videos/bulk", {"action": "explode",
                                      "video_ids": [1]}),
        ("POST", "/api/auth/login", {"secret": "anything"}),
        ("POST", "/api/auth/logout", None),
    ]


async def dump_tables(db) -> dict:
    names = [r["name"] for r in await db.fetch_all(
        "SELECT name FROM sqlite_master WHERE type='table' "
        "AND name NOT LIKE 'sqlite_%' ORDER BY name")]
    return {n: await db.fetch_all(f"SELECT * FROM {n} ORDER BY rowid")
            for n in names}


def tree_files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_mutating_routes_leave_equal_rows_trees_and_audit(site, tmp_path):
    sites = {pkg: copy_site(site, tmp_path / pkg) for pkg in PKGS}
    audit = {pkg: tmp_path / f"{pkg}.audit.log" for pkg in PKGS}

    async def body(apps):
        answers = []
        for method, url, payload in mutation_steps(sites[PORT]):
            kw = ({"data": payload, "headers": {"Content-Type":
                                                "image/jpeg"}}
                  if isinstance(payload, bytes) else
                  {} if payload is None else {"json": payload})
            got = {}
            for pkg in PKGS:
                r = await apps.client[pkg].request(method, url, **kw)
                ct = r.headers.get("Content-Type", "").split(";")[0]
                got[pkg] = (r.status, decoded(await r.read(), ct,
                                              (sites[pkg]["root"],)))
            answers.append((method, url, got))
        tables = {pkg: norm(await dump_tables(apps.db[pkg]),
                            (sites[pkg]["root"],)) for pkg in PKGS}
        return answers, tables

    answers, tables = serve(sites, body, audit)
    for method, url, got in answers:
        assert got[PORT] == got[JAX], (method, url)
    statuses = [got[PORT][0] for _, _, got in answers]
    assert statuses.count(200) + statuses.count(201) >= 35
    assert {400, 404, 409, 413} - set(statuses) <= {413}
    assert tables[PORT] == tables[JAX]
    queued = [r for r in tables[PORT]["jobs"] if r["kind"] == "reencode"]
    assert any(json.loads(r["payload"] or "{}").get("codec") == "av1"
               for r in queued)
    assert tree_files(sites[PORT]["videos"]) == \
        tree_files(sites[JAX]["videos"])
    lines = {pkg: [norm(json.loads(x)) for x in
                   audit[pkg].read_text().splitlines()] for pkg in PKGS}
    assert lines[PORT] == lines[JAX]
    assert sum(e["action"] == "admin.request" for e in lines[PORT]) >= 40
    assert {"video.manifests_regenerated", "video.verified", "storage.gc",
            "delivery.invalidated"} <= {e["action"] for e in lines[PORT]}


# --------------------------------------------------------------------------
# uploads
# --------------------------------------------------------------------------

def upload_kw(path: Path, **fields) -> dict:
    import aiohttp

    form = aiohttp.FormData()
    for k, v in fields.items():
        form.add_field(k, v)
    form.add_field("file", path.read_bytes(), filename=path.name,
                   content_type="application/octet-stream")
    return {"data": form}


def test_upload_leaves_equal_rows_and_bytes(site, tmp_path):
    sites = {pkg: copy_site(site, tmp_path / pkg) for pkg in PKGS}
    src = make_y4m(tmp_path / "movie_clip.y4m", n_frames=24, width=128,
                   height=96, fps=24, seed=11)

    async def body(apps):
        out = {}
        for pkg in PKGS:
            c = apps.client[pkg]
            r = await c.post("/api/videos", **upload_kw(
                src, description="uploaded", category="demo"))
            one = (r.status, norm(await r.json(), (sites[pkg]["root"],)))
            r = await c.post("/api/videos", headers={"X-Vlog-Tenant": "t1"},
                             **upload_kw(src, title="Second"))
            two = (r.status, norm(await r.json(), (sites[pkg]["root"],)))
            bad = tmp_path / f"junk_{pkg}.mp4"
            bad.write_bytes(b"\x00" * 64)
            r = await c.post("/api/videos", **upload_kw(bad))
            junk = (r.status, norm(await r.json(), (sites[pkg]["root"],)))
            r = await c.post("/api/videos", data={"title": "no file"})
            empty = (r.status, await r.json())
            rows = {t: norm(await apps.db[pkg].fetch_all(
                        f"SELECT * FROM {t} ORDER BY id"),
                        (sites[pkg]["root"],)) for t in ("videos", "jobs")}
            out[pkg] = (one, two, junk, empty, rows)
        return out

    out = serve(sites, body)
    assert out[PORT] == out[JAX]
    one, two, junk, empty, rows = out[PORT]
    # a form without multipart: the reference's reader raises, sanitized 500
    assert one[0] == two[0] == 201 and (junk[0], empty[0]) == (400, 500)
    assert one[1]["video"]["title"] == "movie clip"
    assert rows["jobs"][-1]["tenant"] == "t1"
    for pkg in PKGS:
        up = tree_files(sites[pkg]["root"] / "uploads")
        assert sorted(up) == [f"{one[1]['video']['id']}.y4m",
                              f"{two[1]['video']['id']}.y4m"]
        assert all(b == src.read_bytes() for b in up.values())


@pytest.mark.parametrize("extra,status", [(-1, 400), (0, 400), (1, 413)])
def test_upload_refused_past_the_same_size(site, tmp_path, monkeypatch,
                                           extra, status):
    """Past ``MAX_UPLOAD_SIZE_BYTES`` both answer 413 (the streamed-size
    check); at the cap the bytes are taken and the probe refuses them."""
    cap = 64 * 1024
    for pkg in PKGS:
        monkeypatch.setattr(_mod(pkg, "config"), "MAX_UPLOAD_SIZE_BYTES",
                            cap)
    sites = {pkg: copy_site(site, tmp_path / pkg) for pkg in PKGS}
    blob = tmp_path / "big.bin"
    blob.write_bytes(b"\x01" * (cap + extra))

    async def body(apps):
        got = {}
        for pkg in PKGS:
            r = await apps.client[pkg].post("/api/videos", **upload_kw(blob))
            ct = r.headers.get("Content-Type", "").split(";")[0]
            got[pkg] = (r.status, ct, decoded(await r.read(), ct,
                                              (sites[pkg]["root"],)))
        left = {pkg: sorted(p.name for p in
                            (sites[pkg]["root"] / "uploads").iterdir())
                for pkg in PKGS}
        return got, left

    got, left = serve(sites, body)
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == status
    assert left[PORT] == left[JAX] == []       # no temp left behind


# --------------------------------------------------------------------------
# auth
# --------------------------------------------------------------------------

@pytest.mark.parametrize("secret", ["", "s3cret"])
def test_auth_alike_with_and_without_secret(site, tmp_path, monkeypatch,
                                            secret):
    for pkg in PKGS:
        monkeypatch.setattr(_mod(pkg, "config"), "ADMIN_SECRET", secret)
    sites = {pkg: copy_site(site, tmp_path / pkg) for pkg in PKGS}

    async def body(apps):
        out = {}
        for pkg in PKGS:
            c = apps.client[pkg]
            steps = []

            async def step(method, url, **kw):
                r = await c.request(method, url, **kw)
                ct = r.headers.get("Content-Type", "").split(";")[0]
                steps.append((method, url, r.status,
                              decoded(await r.read(), ct,
                                      (sites[pkg]["root"],))
                              if ct == "application/json" else ct))
                return r

            await step("GET", "/api/videos")
            await step("GET", "/api/videos",
                       headers={"X-Admin-Secret": "wrong"})
            await step("GET", "/api/videos",
                       headers={"X-Admin-Secret": "s3cret"})
            await step("GET", "/healthz")
            await step("GET", "/")
            await step("GET", "/ui/app.js")
            await step("GET", "/api/auth/session")
            await step("POST", "/api/auth/login", json={"secret": "wrong"})
            r = await step("POST", "/api/auth/login",
                           json={"secret": "s3cret"})
            csrf = (await r.json()).get("csrf_token") if r.status == 200 \
                else None
            await step("GET", "/api/settings")
            await step("PUT", "/api/settings/x.y", json={"value": 1})
            await step("PUT", "/api/settings/x.y", json={"value": 2},
                       headers={"X-CSRF-Token": csrf or ""})
            await step("GET", "/api/auth/session")
            await step("POST", "/api/auth/logout",
                       headers={"X-CSRF-Token": csrf or ""})
            await step("GET", "/api/settings")
            out[pkg] = steps
        return out

    out = serve(sites, body)
    assert out[PORT] == out[JAX]
    status = {(m, u): s for m, u, s, _ in out[PORT]}
    if secret:
        assert out[PORT][0][2] == 403 and out[PORT][2][2] == 200
        assert out[PORT][10][2] == 403 and out[PORT][11][2] == 200
        assert out[PORT][-1][2] == 403
    else:
        assert set(status.values()) <= {200, 401}


def test_login_throttle_alike(site, monkeypatch):
    for pkg in PKGS:
        monkeypatch.setattr(_mod(pkg, "config"), "ADMIN_SECRET", "s3cret")

    async def body(apps):
        out = {}
        for pkg in PKGS:
            c = apps.client[pkg]
            mod = _mod(pkg, "api.admin_api")
            codes = []
            for _ in range(mod._LOGIN_FREE_ATTEMPTS + 1):
                r = await c.post("/api/auth/login", json={"secret": "no"})
                codes.append((r.status, await r.json()))
            r = await c.post("/api/auth/login", json={"secret": "s3cret"})
            codes.append((r.status, await r.json()))
            # the backoff expires on the module's clock
            t = mod._now()
            monkeypatch.setattr(mod, "_now", lambda t=t: t + 3600.0)
            r = await c.post("/api/auth/login", json={"secret": "s3cret"})
            codes.append((r.status, norm(await r.json())))
            out[pkg] = (codes, dict(mod._LOGIN_FAILS))
        return out

    out = serve({JAX: site, PORT: site}, body)
    assert out[PORT] == out[JAX]
    codes, fails = out[PORT]
    assert [c for c, _ in codes] == [403] * 5 + [429, 429, 200]
    assert fails == {}


# --------------------------------------------------------------------------
# SSE progress
# --------------------------------------------------------------------------

async def read_events(resp, n: int, timeout: float = 10.0) -> list[dict]:
    events = []
    async with asyncio.timeout(timeout):
        while len(events) < n:
            line = (await resp.content.readline()).decode()
            if line.startswith("data: "):
                events.append(json.loads(line[6:]))
    return events


def test_sse_progress_events_alike(tmp_path):
    """Fresh site: one queued and one claimed job. Both apps' streams send
    the two jobs, then the delta of a progress report."""
    from vlog_tpu_torch.db import Database, create_all
    from vlog_tpu_torch.enums import AcceleratorKind
    from vlog_tpu_torch.jobs import claims, videos as vids

    root = tmp_path / "sse"
    (root / "videos").mkdir(parents=True)
    (root / "uploads").mkdir()
    site = {"root": root, "videos": root / "videos",
            "db_url": f"sqlite:///{root / 'site.db'}"}

    async def body():
        db = Database(site["db_url"])
        await db.connect()
        await create_all(db)
        try:
            a = await vids.create_video(db, "A")
            b = await vids.create_video(db, "B")
            await claims.enqueue_job(db, a["id"])
            claimed = await claims.enqueue_job(db, b["id"])
            # the oldest job first: claim a's, then report on b's
            job = await claims.claim_job(db, "w1",
                                         accelerator=AcceleratorKind.TPU)
            assert job["video_id"] == a["id"]
            await claims.update_progress(db, job["id"], "w1", progress=10.0,
                                         current_step="probe")
            async with Admins({JAX: site, PORT: site}) as apps:
                streams = {pkg: await apps.client[pkg].get(
                    "/api/events/progress", params={"poll": "0.2"})
                    for pkg in PKGS}
                first = {pkg: await read_events(r, 2)
                         for pkg, r in streams.items()}
                await claims.update_progress(db, job["id"], "w1",
                                             progress=55.0,
                                             current_step="ladder")
                delta = {pkg: await read_events(r, 1)
                         for pkg, r in streams.items()}
                for r in streams.values():
                    r.close()
                heads = {pkg: r.headers["Content-Type"]
                         for pkg, r in streams.items()}
            return first, delta, heads, claimed
        finally:
            await db.disconnect()

    first, delta, heads, claimed = run_async(body)
    assert first[PORT] == first[JAX] and delta[PORT] == delta[JAX]
    assert heads[PORT] == heads[JAX] == "text/event-stream"
    assert [e["state"] for e in first[PORT]] == ["claimed", "unclaimed"]
    assert first[PORT][1]["job_id"] == claimed
    assert (delta[PORT][0]["progress"], delta[PORT][0]["current_step"]) \
        == (55.0, "ladder")


# --------------------------------------------------------------------------
# the admin UI
# --------------------------------------------------------------------------

@pytest.mark.parametrize("url,path", [
    ("/", "admin/index.html"), ("/ui/app.js", "admin/app.js"),
    ("/ui/style.css", "shared/style.css")])
def test_admin_ui_assets_are_byte_copies(site, url, path):
    ref = Path(_mod(JAX, "web").__file__).parent / path
    port = Path(_mod(PORT, "web").__file__).parent / path
    assert port.read_bytes() == ref.read_bytes()

    async def body(apps):
        return await apps.both("GET", url)

    got = serve({JAX: site, PORT: site}, body)
    assert got[PORT] == got[JAX]
    assert got[PORT][:2] == (200, ref.read_bytes())
