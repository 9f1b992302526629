"""First-party web UIs (public + admin), served by the API processes (a
copy of ``vlog_tpu/web``; ``public/*``, ``admin/*`` and
``shared/style.css`` are byte copies of the JAX package's).

Reference parity: web/public (browse/watch SPA) and web/admin
(dashboard/videos/jobs/workers/settings/webhooks SPA), which the
reference builds from TypeScript + Tailwind via a node toolchain. Here
the UIs are dependency-free vanilla HTML/CSS/JS served straight from
the package — no build step — and video playback is a first-party MSE
player (``public/player.js``) that speaks the CMAF/fMP4 HLS this
framework emits (master playlist -> variant + audio-group playlists ->
EXT-X-MAP init + m4s appends), since the reference's <video> tag relies
on hls.js which we do not vendor.

Both API apps mount :func:`attach_ui`, which serves ``index.html`` at
``/`` and hashed assets under ``/ui/``.
"""

from __future__ import annotations

from pathlib import Path

from aiohttp import web

WEB_ROOT = Path(__file__).resolve().parent

UI_MIME = {
    ".html": "text/html; charset=utf-8",
    ".js": "application/javascript; charset=utf-8",
    ".css": "text/css; charset=utf-8",
    ".svg": "image/svg+xml",
    ".ico": "image/x-icon",
    ".png": "image/png",
}


def _asset_response(path: Path) -> web.Response:
    if not path.is_file():
        return web.json_response({"error": "not found"}, status=404)
    body = path.read_bytes()
    mime = UI_MIME.get(path.suffix.lower(), "application/octet-stream")
    # Assets are versioned by deploy, not by hash; keep caching short so
    # an upgraded worker pod serves a coherent UI without cache busting.
    return web.Response(body=body, headers={
        "Content-Type": mime,
        "Cache-Control": "no-cache",
        "X-Content-Type-Options": "nosniff",
    })


def attach_ui(app: web.Application, which: str) -> None:
    """Mount the ``which`` ("public" | "admin") UI on an aiohttp app."""
    root = WEB_ROOT / which
    if not root.is_dir():  # pragma: no cover - packaging error
        raise FileNotFoundError(root)

    async def index(request: web.Request) -> web.Response:
        return _asset_response(root / "index.html")

    async def asset(request: web.Request) -> web.Response:
        rel = Path(request.match_info["tail"])
        if rel.is_absolute() or ".." in rel.parts:
            return web.json_response({"error": "bad path"}, status=400)
        path = root / rel
        if not path.is_file():         # common assets (stylesheet) live in
            path = WEB_ROOT / "shared" / rel   # shared/, used by both UIs
        return _asset_response(path)

    app.router.add_get("/", index)
    app.router.add_get("/ui/{tail:.+}", asset)


UI_EXEMPT_PREFIXES = ("/ui/",)


def is_ui_path(path: str) -> bool:
    """True for routes that serve static UI shell (no data, no secrets).

    The admin auth middleware exempts these so a browser can load the
    login shell; every ``/api/*`` call still requires the admin secret.
    """
    return path == "/" or any(path.startswith(p) for p in UI_EXEMPT_PREFIXES)
