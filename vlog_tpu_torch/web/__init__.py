"""First-party web UI served by the public API (a copy of the public half
of ``vlog_tpu/web``; the admin UI is not ported, ROADMAP Queue A item
13d).

Reference parity: web/public (browse/watch SPA), which the reference
builds from TypeScript + Tailwind via a node toolchain. Here the UI is
dependency-free vanilla HTML/CSS/JS served straight from the package —
no build step — and video playback is a first-party MSE player
(``public/player.js``) that speaks the CMAF/fMP4 HLS this framework
emits (master playlist -> variant + audio-group playlists -> EXT-X-MAP
init + m4s appends). ``public/*`` and ``shared/style.css`` are byte
copies of the JAX package's.

The public app mounts :func:`attach_ui`, which serves ``index.html`` at
``/`` and assets under ``/ui/``.
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
    """Mount the ``which`` UI (``"public"``) on an aiohttp app."""
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

