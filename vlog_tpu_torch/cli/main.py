"""``vlog-tpu`` console client.

Reference parity: cli/main.py:250-1053 — upload, list, status, delete/
restore/retranscode, worker management, settings, webhooks — speaking to
the admin (:9001) and public (:9000) APIs over HTTP, plus launcher
subcommands for the three services and the two worker flavors so one
entrypoint runs the whole system.

A copy of ``vlog_tpu/cli/main.py`` with the same subcommands, options and
output; ``serve`` and ``worker`` launch the port's services, and HTTP goes
through ``aiohttp`` (the port's one HTTP library) behind the small
blocking client below. Run it as ``python -m vlog_tpu_torch.cli.main`` or
through the ``vlog-tpu-torch`` script.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time
from pathlib import Path

import aiohttp

ADMIN_URL = os.environ.get("VLOG_ADMIN_URL", "http://127.0.0.1:9001")
PUBLIC_URL = os.environ.get("VLOG_PUBLIC_URL", "http://127.0.0.1:9000")
ADMIN_SECRET = os.environ.get("VLOG_ADMIN_SECRET", "")


# connect and each read bounded, no total (a large upload takes long)
_TIMEOUT = aiohttp.ClientTimeout(total=None, sock_connect=600.0,
                                 sock_read=600.0)


class Response:
    """A finished HTTP exchange: the status and the whole body."""

    def __init__(self, status_code: int, content: bytes):
        self.status_code = status_code
        self.content = content

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", "replace")

    def json(self):
        return json.loads(self.content)


class Client:
    """A blocking HTTP client over ``aiohttp``: each call runs to its end
    on the client's own event loop (so it must not be called from a
    thread that is running one)."""

    def __init__(self, base: str, headers: dict | None = None):
        self._loop = asyncio.new_event_loop()
        self._session = self._loop.run_until_complete(
            self._open(base, headers or {}))

    @staticmethod
    async def _open(base: str, headers: dict) -> aiohttp.ClientSession:
        return aiohttp.ClientSession(base_url=base, headers=headers,
                                     timeout=_TIMEOUT)

    async def _request(self, method: str, path: str, *, params=None,
                       json=None, data=None, files=None) -> Response:
        body = None
        if files is not None:
            # multipart: the form fields, then each file part streamed
            body = aiohttp.FormData()
            for k, v in (data or {}).items():
                body.add_field(k, v)
            for k, (filename, fp) in files.items():
                body.add_field(k, fp, filename=filename,
                               content_type="application/octet-stream")
        async with self._session.request(method, path, params=params,
                                         json=json, data=body) as resp:
            return Response(resp.status, await resp.read())

    def request(self, method: str, path: str, **kw) -> Response:
        return self._loop.run_until_complete(
            self._request(method, path, **kw))

    def get(self, path: str, **kw) -> Response:
        return self.request("GET", path, **kw)

    def post(self, path: str, **kw) -> Response:
        return self.request("POST", path, **kw)

    def put(self, path: str, **kw) -> Response:
        return self.request("PUT", path, **kw)

    def delete(self, path: str, **kw) -> Response:
        return self.request("DELETE", path, **kw)

    def close(self) -> None:
        self._loop.run_until_complete(self._session.close())
        self._loop.close()

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _fetch_to(url: str, target: Path) -> int:
    """GET ``url`` (redirects followed) into ``target``, streamed; the
    HTTP status (nothing is written on a status >= 400)."""

    async def fetch() -> int:
        async with aiohttp.ClientSession(timeout=_TIMEOUT) as s, \
                s.get(url, allow_redirects=True) as r:
            if r.status >= 400:
                return r.status
            with open(target, "wb") as fp:
                async for chunk in r.content.iter_chunked(1 << 20):
                    fp.write(chunk)
            return r.status

    return asyncio.run(fetch())


def _client(base: str) -> Client:
    headers = {}
    if ADMIN_SECRET:
        headers["X-Admin-Secret"] = ADMIN_SECRET
    return Client(base, headers)


def _die(resp: Response) -> None:
    try:
        msg = resp.json().get("error", resp.text)
    except Exception:
        msg = resp.text
    print(f"error {resp.status_code}: {msg}", file=sys.stderr)
    sys.exit(1)


def _ok(resp: Response) -> dict:
    if resp.status_code >= 400:
        _die(resp)
    return resp.json()


def _fmt_duration(s) -> str:
    s = float(s or 0)
    return f"{int(s // 60)}:{s % 60:04.1f}"


# --------------------------------------------------------------------------
# Commands
# --------------------------------------------------------------------------

def cmd_upload(args) -> None:
    path = Path(args.file)
    if not path.exists():
        sys.exit(f"{path}: no such file")
    with _client(ADMIN_URL) as c, open(path, "rb") as fp:
        fields = {"title": args.title or path.stem.replace("_", " ")}
        if args.description:
            fields["description"] = args.description
        if args.category:
            fields["category"] = args.category
        resp = c.post("/api/videos", data=fields,
                      files={"file": (path.name, fp)})
        data = _ok(resp)
    video = data["video"]
    print(f"uploaded: video {video['id']} slug={video['slug']} "
          f"job={data['job_id']}")
    if args.wait:
        _wait_ready(video["id"])


def _wait_ready(video_id: int, poll_s: float = 3.0) -> None:
    with _client(ADMIN_URL) as c:
        last = None
        while True:
            data = _ok(c.get(f"/api/videos/{video_id}"))
            v = data["video"]
            jobs = {j["kind"]: j for j in data["jobs"]}
            tj = jobs.get("transcode", {})
            line = (f"status={v['status']} progress="
                    f"{tj.get('progress', 0):.1f}% "
                    f"step={tj.get('current_step') or '-'}")
            if line != last:
                print(line)
                last = line
            if v["status"] in ("ready", "failed"):
                if v["status"] == "failed":
                    sys.exit(f"transcode failed: {v.get('error')}")
                return
            time.sleep(poll_s)


def cmd_list(args) -> None:
    with _client(ADMIN_URL) as c:
        params = {"limit": args.limit}
        if args.status:
            params["status"] = args.status
        data = _ok(c.get("/api/videos", params=params))
    print(f"{'id':>5} {'status':<10} {'dur':>7} {'res':>10} slug")
    for v in data["videos"]:
        res = f"{v['width'] or '?'}x{v['height'] or '?'}"
        print(f"{v['id']:>5} {v['status']:<10} "
              f"{_fmt_duration(v['duration_s']):>7} {res:>10} {v['slug']}")
    print(f"({len(data['videos'])}/{data['total']})")


def cmd_status(args) -> None:
    with _client(ADMIN_URL) as c:
        data = _ok(c.get(f"/api/videos/{args.video_id}"))
    v = data["video"]
    print(f"video {v['id']} [{v['status']}] {v['title']!r} slug={v['slug']}")
    print(f"  {v['width']}x{v['height']} @{v['fps']}fps "
          f"{_fmt_duration(v['duration_s'])} err={v.get('error')}")
    for q in data["qualities"]:
        print(f"  rung {q['name']:>6}: {q['width']}x{q['height']} "
              f"{(q['video_bitrate'] or 0) // 1000}kbps")
    for j in data["jobs"]:
        print(f"  job {j['kind']:<13} [{j['state']}] "
              f"{j['progress']:.1f}% attempt={j['attempt']} "
              f"step={j['current_step'] or '-'}")
    tr = data.get("transcription")
    if tr:
        print(f"  transcript [{tr['status']}] lang={tr['language']}")
    if args.watch and v["status"] not in ("ready", "failed"):
        _wait_ready(v["id"])


def cmd_delete(args) -> None:
    with _client(ADMIN_URL) as c:
        _ok(c.delete(f"/api/videos/{args.video_id}"))
    print("deleted (soft; restore with `vlog-tpu restore`)")


def cmd_restore(args) -> None:
    with _client(ADMIN_URL) as c:
        _ok(c.post(f"/api/videos/{args.video_id}/restore"))
    print("restored")


def cmd_retranscode(args) -> None:
    with _client(ADMIN_URL) as c:
        data = _ok(c.post(f"/api/videos/{args.video_id}/retranscode",
                          json={"force": args.force}))
    print(f"enqueued job {data['job_id']}")


def cmd_workers(args) -> None:
    with _client(ADMIN_URL) as c:
        data = _ok(c.get("/api/workers"))
    for w in data["workers"]:
        mark = "ONLINE " if w["online"] else "offline"
        print(f"{mark} {w['name']:<24} {w['accelerator']:<6} "
              f"v{w['code_version'] or '?'} {w['status']}")
    if not data["workers"]:
        print("(no workers registered)")


def cmd_worker_revoke(args) -> None:
    with _client(ADMIN_URL) as c:
        data = _ok(c.post(f"/api/workers/{args.name}/revoke"))
    print(f"revoked {data['keys_revoked']} key(s)")


def cmd_settings(args) -> None:
    with _client(ADMIN_URL) as c:
        if args.action == "list":
            data = _ok(c.get("/api/settings"))
            for k, v in sorted(data["settings"].items()):
                print(f"{k} = {v!r}")
        elif args.action == "set":
            value: object = args.value
            try:
                value = json.loads(args.value)
            except (json.JSONDecodeError, TypeError):
                pass       # keep as string
            _ok(c.put(f"/api/settings/{args.key}", json={"value": value}))
            print("ok")
        elif args.action == "unset":
            _ok(c.delete(f"/api/settings/{args.key}"))
            print("ok")


def cmd_webhooks(args) -> None:
    with _client(ADMIN_URL) as c:
        if args.action == "list":
            data = _ok(c.get("/api/webhooks"))
            for w in data["webhooks"]:
                state = "on" if w["active"] else "off"
                print(f"{w['id']:>4} [{state}] {w['url']} "
                      f"events={','.join(w['events']) or '*'}")
        elif args.action == "add":
            data = _ok(c.post("/api/webhooks", json={
                "url": args.url, "secret": args.secret,
                "events": args.events.split(",") if args.events else []}))
            print(f"webhook {data['id']}")
        elif args.action == "rm":
            _ok(c.delete(f"/api/webhooks/{args.webhook_id}"))
            print("ok")


def cmd_manifests_regenerate(args) -> None:
    """Rebuild master.m3u8/manifest.mpd for a video from the DB +
    on-disk rung trees (reference CLI manifests-regenerate)."""
    with _client(ADMIN_URL) as c:
        d = _ok(c.post(f"/api/videos/{args.video_id}/manifests/regenerate"))
    print(f"regenerated: variants={','.join(d['variants'])}"
          + (f" audio={','.join(d['audio'])}" if d.get("audio") else "")
          + (f" skipped={','.join(d['skipped'])}" if d["skipped"] else ""))


def cmd_download(args) -> None:
    """Ingest a video FROM A URL: fetch to a temp file, then upload it
    through the admin API (reference CLI download, which shells to
    yt-dlp).  Direct media URLs stream over plain HTTP(S); for
    portal/page URLs a system ``yt-dlp`` is used when installed."""
    import shutil
    import subprocess
    import tempfile

    url = args.url
    tmpdir = Path(tempfile.mkdtemp(prefix="vlog-dl-"))
    try:
        name = (url.rsplit("/", 1)[-1].split("?")[0] or "download") \
            if "/" in url else "download"
        target = tmpdir / (name if "." in name else name + ".mp4")
        ytdlp = shutil.which("yt-dlp")
        direct = any(name.lower().endswith(ext) for ext in
                     (".mp4", ".mkv", ".webm", ".mov", ".y4m", ".ts",
                      ".avi", ".m4v"))
        if direct or ytdlp is None:
            if not direct and ytdlp is None:
                print("note: yt-dlp not installed; attempting a direct "
                      "HTTP fetch", file=sys.stderr)
            status = _fetch_to(url, target)
            if status >= 400:
                print(f"error {status} fetching {url}", file=sys.stderr)
                sys.exit(1)
        else:
            out_tpl = str(tmpdir / "%(title)s.%(ext)s")
            proc = subprocess.run([ytdlp, "-o", out_tpl, "--no-playlist",
                                   url])
            if proc.returncode != 0:
                sys.exit(proc.returncode)
            files = [p for p in tmpdir.iterdir() if p.is_file()]
            if not files:
                print("yt-dlp produced no file", file=sys.stderr)
                sys.exit(1)
            target = max(files, key=lambda p: p.stat().st_size)
        title = args.title or target.stem.replace("_", " ")
        with _client(ADMIN_URL) as c, open(target, "rb") as fp:
            d = _ok(c.post("/api/videos", data={"title": title},
                           files={"file": (target.name, fp)}))
        v = d["video"]
        print(f"video #{v['id']} '{v['title']}' uploaded; "
              f"job #{d['job_id']} queued")
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def cmd_serve(args) -> None:
    if args.service == "worker-api":
        from vlog_tpu_torch.api.worker_api import main as m
    elif args.service == "admin":
        from vlog_tpu_torch.api.admin_api import main as m
    elif args.service == "public":
        from vlog_tpu_torch.api.public_api import main as m
    m()


def cmd_worker(args) -> None:
    if args.flavor == "local":
        from vlog_tpu_torch.worker.daemon import main as m
    else:
        from vlog_tpu_torch.worker.remote import main as m
    m(args.rest)


# --------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vlog-tpu",
        description="TPU-native video platform console client")
    sub = p.add_subparsers(dest="cmd", required=True)

    u = sub.add_parser("upload", help="upload a video and enqueue transcode")
    u.add_argument("file")
    u.add_argument("--title")
    u.add_argument("--description")
    u.add_argument("--category")
    u.add_argument("--wait", action="store_true",
                   help="poll until ready/failed")
    u.set_defaults(fn=cmd_upload)

    li = sub.add_parser("list", help="list videos")
    li.add_argument("--status")
    li.add_argument("--limit", type=int, default=50)
    li.set_defaults(fn=cmd_list)

    st = sub.add_parser("status", help="video detail + job progress")
    st.add_argument("video_id", type=int)
    st.add_argument("--watch", action="store_true")
    st.set_defaults(fn=cmd_status)

    d = sub.add_parser("delete", help="soft-delete a video")
    d.add_argument("video_id", type=int)
    d.set_defaults(fn=cmd_delete)

    re = sub.add_parser("restore", help="restore a soft-deleted video")
    re.add_argument("video_id", type=int)
    re.set_defaults(fn=cmd_restore)

    rt = sub.add_parser("retranscode", help="re-enqueue the transcode job")
    rt.add_argument("video_id", type=int)
    rt.add_argument("--force", action="store_true")
    rt.set_defaults(fn=cmd_retranscode)

    mr = sub.add_parser("manifests-regenerate",
                        help="rebuild master/DASH manifests for a video")
    mr.add_argument("video_id", type=int)
    mr.set_defaults(fn=cmd_manifests_regenerate)

    dl = sub.add_parser("download",
                        help="ingest a video from a URL (yt-dlp when "
                             "installed, direct HTTP otherwise)")
    dl.add_argument("url")
    dl.add_argument("--title", default="")
    dl.set_defaults(fn=cmd_download)

    w = sub.add_parser("workers", help="list the worker fleet")
    w.set_defaults(fn=cmd_workers)

    wr = sub.add_parser("worker-revoke", help="revoke a worker's API keys")
    wr.add_argument("name")
    wr.set_defaults(fn=cmd_worker_revoke)

    se = sub.add_parser("settings", help="inspect/update settings")
    se.add_argument("action", choices=["list", "set", "unset"])
    se.add_argument("key", nargs="?")
    se.add_argument("value", nargs="?")
    se.set_defaults(fn=cmd_settings)

    wh = sub.add_parser("webhooks", help="manage webhooks")
    wh.add_argument("action", choices=["list", "add", "rm"])
    wh.add_argument("url", nargs="?")
    wh.add_argument("--secret")
    wh.add_argument("--events", help="comma-separated event filter")
    wh.add_argument("--webhook-id", type=int)
    wh.set_defaults(fn=cmd_webhooks)

    sv = sub.add_parser("serve", help="run one of the API services")
    sv.add_argument("service", choices=["worker-api", "admin", "public"])
    sv.set_defaults(fn=cmd_serve)

    wk = sub.add_parser("worker", help="run a worker daemon")
    wk.add_argument("flavor", choices=["local", "remote"])
    wk.add_argument("rest", nargs=argparse.REMAINDER,
                    help="flags passed through to the worker")
    wk.set_defaults(fn=cmd_worker)
    return p


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    if args.cmd == "settings" and args.action in ("set", "unset") \
            and not args.key:
        sys.exit("settings set/unset requires a key")
    if args.cmd == "settings" and args.action == "set" and args.value is None:
        sys.exit("settings set requires a value")
    if args.cmd == "webhooks" and args.action == "add" and not args.url:
        sys.exit("webhooks add requires a url")
    if args.cmd == "webhooks" and args.action == "rm" \
            and args.webhook_id is None:
        sys.exit("webhooks rm requires --webhook-id")
    args.fn(args)


if __name__ == "__main__":
    main()
