"""HTTP semantics for cached media: conditional, range, CORS, HEAD (a copy
of ``vlog_tpu/delivery/http.py``).

One response function serves BOTH the cached and the uncached path — a
cache-off deployment (``VLOG_DELIVERY_CACHE_BYTES=0``) still builds its
responses from the same :class:`~vlog_tpu_torch.delivery.cache.CacheEntry`
the fill produced, it just doesn't retain the entry. That is what makes
"cached responses are byte-identical to uncached ones" a structural
property instead of a test hope.

Implemented subset (what MSE/hls players actually send):

- strong ETags (the manifest sha256 when the tree has one), handled for
  ``If-None-Match`` (list form, ``W/`` prefixes, ``*``) -> **304**;
  ``If-Modified-Since`` -> **304** for ETag-less revalidators
  (``If-None-Match`` takes precedence when both are present)
- single-range ``Range: bytes=a-b | a- | -n`` -> **206** with
  ``Content-Range``; syntactically-valid-but-unsatisfiable -> **416**;
  multi-range requests are answered with the full **200** body (allowed
  by RFC 9110 §14.2 — no media player sends them)
- ``If-Range`` with either an ETag or an HTTP-date validator; a failed
  validator serves the full 200 body (never a stale-ranged splice)
- HEAD mirrors every header including ``Content-Length`` with an empty
  body; OPTIONS answers CORS preflight so cross-origin players can
  probe segments (the reference relies on its CDN for this tier).
"""

from __future__ import annotations

import asyncio
import os
import time
from email.utils import formatdate, parsedate_to_datetime
from stat import S_ISREG

from aiohttp import web

from vlog_tpu_torch.delivery.cache import CacheEntry, FileEntry

Entry = CacheEntry | FileEntry

# The reference subclasses StaticFiles for exactly this table
# (HLSStaticFiles, docs/ARCHITECTURE.md:59-62).
MEDIA_MIME = {
    ".m3u8": "application/vnd.apple.mpegurl",
    ".mpd": "application/dash+xml",
    ".m4s": "video/iso.segment",
    ".mp4": "video/mp4",
    ".ts": "video/mp2t",
    ".vtt": "text/vtt",
    ".jpg": "image/jpeg",
    ".jpeg": "image/jpeg",
    ".png": "image/png",
    ".y4m": "application/octet-stream",
    ".aac": "audio/aac",
}

# Mutable playlist suffixes: short-TTL cache entries, no-cache clients.
MUTABLE_SUFFIXES = (".m3u8", ".mpd")

CACHE_IMMUTABLE = "public, max-age=31536000, immutable"
CACHE_MUTABLE = "no-cache"

# Cross-origin playback surface: players fetch manifests/segments with
# Range and revalidation headers and must be able to READ the range /
# validator response headers, not just receive the bytes.
CORS_HEADERS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Expose-Headers":
        "Content-Length, Content-Range, Accept-Ranges, ETag, Last-Modified",
}
PREFLIGHT_HEADERS = {
    **CORS_HEADERS,
    "Access-Control-Allow-Methods": "GET, HEAD, OPTIONS",
    "Access-Control-Allow-Headers":
        "Range, If-None-Match, If-Modified-Since, If-Range",
    "Access-Control-Max-Age": "86400",
}


def preflight_response() -> web.Response:
    """CORS preflight for the media routes (OPTIONS)."""
    return web.Response(status=204, headers=PREFLIGHT_HEADERS)


def cache_control(entry: Entry) -> str:
    return CACHE_IMMUTABLE if entry.immutable else CACHE_MUTABLE


def etag_matches(header: str, etag: str) -> bool:
    """RFC 9110 If-None-Match: comma list, weak prefixes, ``*``."""
    if header.strip() == "*":
        return True
    for cand in header.split(","):
        cand = cand.strip()
        if cand.startswith("W/"):
            cand = cand[2:]
        if cand == etag:
            return True
    return False


class RangeNotSatisfiable(ValueError):
    """A syntactically valid bytes range outside the representation."""


def parse_range(header: str, size: int) -> tuple[int, int] | None:
    """``(start, end_inclusive)`` for a single satisfiable bytes range.

    None means "serve the full body": absent/other units, malformed
    syntax (RFC 9110 says ignore), or multi-range. Raises
    :class:`RangeNotSatisfiable` for well-formed ranges that miss the
    representation entirely (416 + ``Content-Range: bytes */size``).
    """
    if not header or not header.startswith("bytes="):
        return None
    spec = header[len("bytes="):].strip()
    if "," in spec:             # multi-range: legal to answer with 200
        return None
    start_s, dash, end_s = spec.partition("-")
    if not dash:
        return None
    start_s, end_s = start_s.strip(), end_s.strip()
    try:
        if not start_s:                     # suffix form: last N bytes
            n = int(end_s)
            if n <= 0:
                raise RangeNotSatisfiable(header)
            if size == 0:
                raise RangeNotSatisfiable(header)
            return max(0, size - n), size - 1
        start = int(start_s)
        if start >= size:
            raise RangeNotSatisfiable(header)
        end = int(end_s) if end_s else size - 1
    except ValueError as exc:
        if isinstance(exc, RangeNotSatisfiable):
            raise
        return None                         # malformed -> full body
    if end < start:
        return None
    return start, min(end, size - 1)


def _unmodified_since(header: str | None, entry: Entry) -> bool:
    """If-Modified-Since -> 304 eligibility (ETag-less revalidators —
    the header the preflight invites clients to send)."""
    if header is None:
        return False
    try:
        cut = parsedate_to_datetime(header).timestamp()
    except (TypeError, ValueError):
        return False
    return int(entry.mtime) <= cut


def parse_retry_after(value: str | None) -> float | None:
    """``Retry-After`` -> seconds, or None when absent/garbled.

    Accepts both RFC 9110 forms: delta-seconds and an HTTP-date (the
    date form converts to a from-now delta, floored at 0). The peer-fill
    path uses this to honor a shedding owner's own backoff hint as the
    cooldown instead of the flat configured one.
    """
    if not value:
        return None
    value = value.strip()
    try:
        return max(0.0, float(int(value)))
    except ValueError:
        pass
    try:
        return max(0.0, parsedate_to_datetime(value).timestamp()
                   - time.time())
    except (TypeError, ValueError):
        return None


def _if_range_allows(header: str | None, entry: Entry) -> bool:
    """True when a Range header may be honored under this If-Range."""
    if header is None:
        return True
    header = header.strip()
    if header.startswith(('"', "W/")):
        # entity-tag form; weak tags never match for ranges (RFC 9110)
        return header == entry.etag
    try:
        cut = parsedate_to_datetime(header).timestamp()
    except (TypeError, ValueError):
        return False
    # RFC 9110 §13.1.5: the date must EXACTLY match the current
    # Last-Modified ("not earlier than"-style laxity would let a tree
    # restored with an older mtime splice ranges across two bodies).
    # Last-Modified granularity is whole seconds on the wire.
    return int(entry.mtime) == int(cut)


def entry_response(request: web.Request, entry: Entry,
                   ) -> web.StreamResponse:
    """The full conditional/range state machine over a delivery entry.

    Buffered entries (:class:`CacheEntry`) answer from RAM; file-backed
    entries (:class:`FileEntry` — the large-object bypass and big L2
    hits) answer 200/206 zero-copy via :class:`SendfileResponse`. Both
    kinds flow through the SAME decision tree with the SAME validators
    (the entry's digest ETag and origin mtime, never a fresh ``stat``),
    so the four serve paths — L1, L2, peer, bypass — are byte- and
    header-identical by construction.
    """
    base = {
        "Content-Type": entry.mime,
        "ETag": entry.etag,
        "Last-Modified": formatdate(entry.mtime, usegmt=True),
        "Accept-Ranges": "bytes",
        "Cache-Control": cache_control(entry),
        **CORS_HEADERS,
    }
    inm = request.headers.get("If-None-Match")
    if inm is not None and etag_matches(inm, entry.etag):
        not_modified = dict(base)
        not_modified.pop("Content-Type")    # 304 carries no payload head
        return web.Response(status=304, headers=not_modified)
    if inm is None and _unmodified_since(
            request.headers.get("If-Modified-Since"), entry):
        not_modified = dict(base)
        not_modified.pop("Content-Type")
        return web.Response(status=304, headers=not_modified)

    size = entry.size
    rng = None
    # RFC 9110 §13.1.5: a non-matching If-Range means IGNORE the Range
    # header outright — including its 416 path, or a resume against a
    # republished-smaller body would 416 instead of getting the new 200.
    if _if_range_allows(request.headers.get("If-Range"), entry):
        try:
            rng = parse_range(request.headers.get("Range", ""), size)
        except RangeNotSatisfiable:
            return web.Response(
                status=416,
                headers={**base, "Content-Range": f"bytes */{size}"})

    if rng is None:
        status, start, length = 200, 0, size
    else:
        start, end = rng
        status, length = 206, end - start + 1
        base["Content-Range"] = f"bytes {start}-{end}/{size}"

    if request.method == "HEAD":
        # mirror the GET headers (Content-Length included) sans body —
        # answered from metadata for both kinds (no file open for HEAD)
        base["Content-Length"] = str(length)
        return web.Response(status=status, headers=base)
    if isinstance(entry, FileEntry):
        return SendfileResponse(entry.path, status=status, offset=start,
                                count=length, headers=base)
    body = entry.body if rng is None else entry.body[start:start + length]
    return web.Response(status=status, body=body, headers=base)


class SendfileResponse(web.FileResponse):
    """Zero-copy body transport, nothing else.

    Every conditional/range decision — 304, 416, If-Range, the byte
    window — was already made by :func:`entry_response` against the
    delivery entry's validators, so this class must NOT re-run
    ``FileResponse``'s stat-based machinery: aiohttp computes an
    ``mtime-size`` ETag and date-only If-Range, which would diverge from
    the digest ETags the buffered paths emit. ``prepare`` is overridden
    to open + fstat the file off-loop and hand straight to
    ``FileResponse._sendfile`` (``loop.sendfile`` → ``os.sendfile``,
    with aiohttp's own chunked fallback where unavailable) using the
    precomputed offset/count and the caller's headers verbatim.
    """

    def __init__(self, path, *, status: int, offset: int, count: int,
                 headers: dict[str, str]):
        super().__init__(path, status=status, headers=headers)
        self._offset = offset
        self._count = count

    def _open_stat(self):
        fobj = open(self._path, "rb")
        try:
            st = os.fstat(fobj.fileno())
        except OSError:
            fobj.close()
            raise
        if not S_ISREG(st.st_mode):
            fobj.close()
            raise FileNotFoundError(str(self._path))
        return fobj

    async def prepare(self, request: web.BaseRequest):
        loop = asyncio.get_running_loop()
        try:
            fobj = await loop.run_in_executor(None, self._open_stat)
        except OSError:
            # the file vanished between fill and serve (republish race):
            # degrade to a clean 404 rather than a torn stream
            self.set_status(404)
            self.content_length = 0
            for name in ("ETag", "Last-Modified", "Content-Range",
                         "Cache-Control", "Content-Type"):
                self.headers.pop(name, None)
            return await web.StreamResponse.prepare(self, request)
        try:
            self.content_length = self._count
            if self._count == 0:
                return await web.StreamResponse.prepare(self, request)
            # FileResponse._sendfile: loop.sendfile over the transport,
            # falling back to chunked executor reads when unsupported
            return await self._sendfile(request, fobj, self._offset,
                                        self._count)
        finally:
            fut = loop.run_in_executor(None, fobj.close)
            _CLOSE_FUTURES.add(fut)
            fut.add_done_callback(_CLOSE_FUTURES.discard)


# strong refs to in-flight close futures (mirrors aiohttp's own pattern)
_CLOSE_FUTURES: set = set()
