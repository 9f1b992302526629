"""Error sanitization for API responses (a copy of
``vlog_tpu/api/errors.py``).

Reference analog: api/errors.py (241 LoC) — detailed errors go to logs
and the jobs table (operators need the truth); what crosses the API
boundary to clients is scrubbed of internal detail (filesystem paths,
driver/module names, stack-trace fragments) and truncated. The public
API sanitizes everything; the admin API sanitizes only 5xx bodies (an
authenticated operator gets real 4xx validation messages, but an
unexpected exception's repr still must not leak paths to a browser).
"""

from __future__ import annotations

import logging
import re

log = logging.getLogger("vlog.api.errors")

ERROR_MAX_LEN = 300

# Anything matching these marks a message as "internal" — it gets the
# generic text for its category instead of a scrubbed passthrough.
_INTERNAL_PATTERNS = [
    re.compile(p, re.I) for p in (
        r"(/[\w.\-]+){2,}",              # absolute filesystem paths
        r'File "[^"]+"',                 # traceback frames
        r"line \d+",
        r"\bsqlite3?\b",
        r"\blibpq\b|\bpostgres\b|\bsqlstate\b",
        r"\bTraceback\b",
        r"\bctypes\b|\bnumpy\b|\bjax\b",
        r"Permission denied|No such file or directory",
        r"UNIQUE constraint|FOREIGN KEY constraint",
        r"\.py:\d+",
    )
]

# category fragment -> client-safe message
_GENERIC = (
    ("decode", "The source file could not be read."),
    ("encode", "Video processing failed."),
    ("transcode", "Video processing failed."),
    ("database", "A storage error occurred. Please retry."),
    ("locked", "The service is busy. Please retry."),
    ("timeout", "The operation timed out. Please retry."),
    ("connect", "A backend service is unreachable."),
)
_FALLBACK = "An internal error occurred."


def sanitize_error(message: str | BaseException,
                   *, max_len: int = ERROR_MAX_LEN) -> str:
    """Client-safe rendering of an error: internal details replaced by
    a generic category message, everything truncated."""
    msg = str(message) or _FALLBACK
    if any(p.search(msg) for p in _INTERNAL_PATTERNS):
        low = msg.lower()
        for frag, generic in _GENERIC:
            if frag in low:
                return generic
        return _FALLBACK
    if len(msg) > max_len:
        return msg[: max_len - 1] + "…"
    return msg


def public_job_error(error: str | None) -> str | None:
    """What the public API may say about a failed job."""
    if not error:
        return None
    return sanitize_error(error)


# --------------------------------------------------------------------------
# Request-ID tracing (reference common.py X-Request-ID middleware):
# every response carries an id — caller-supplied when sane, minted
# otherwise — and unhandled errors log it, so a user-reported failure
# can be joined to its log line across all three API planes.
# --------------------------------------------------------------------------

_REQ_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")
# trace/span ids are hex (obs/trace.py new_id); anything else is junk
_TRACE_ID_RE = re.compile(r"^[0-9a-f]{8,64}$")

# every consumer is an aiohttp app; import plainly.
import uuid as _uuid  # noqa: E402

from aiohttp import web as _web  # noqa: E402


@_web.middleware
async def request_id_middleware(request, handler):
    """Outermost middleware on every plane: every response (including
    framework HTTPExceptions and unhandled 500s) carries X-Request-ID,
    and an unhandled exception that reaches this tier is converted to a
    sanitized 500 WITH the id — so the one response class where log
    correlation matters most never ships without it.  Planes with their
    own error middleware log rid themselves (they sit inside this one
    and catch first)."""
    rid = request.headers.get("X-Request-ID", "")
    if not _REQ_ID_RE.match(rid):
        rid = _uuid.uuid4().hex[:16]
    request["request_id"] = rid
    # Trace propagation (obs/trace.py): honor caller-supplied trace
    # context so a worker's HTTP hop joins the job's trace — handlers
    # read request["trace_id"] / request["parent_span_id"] when they
    # record server-side spans, and every response echoes the trace id
    # so either end of the hop can be joined to the waterfall.
    tid = (request.headers.get("X-Trace-Id") or "").strip().lower()
    pid = (request.headers.get("X-Parent-Span") or "").strip().lower()
    request["trace_id"] = tid if _TRACE_ID_RE.match(tid) else None
    request["parent_span_id"] = pid if _TRACE_ID_RE.match(pid) else None
    try:
        resp = await handler(request)
    except _web.HTTPException as exc:
        exc.headers["X-Request-ID"] = rid
        if request["trace_id"]:
            exc.headers["X-Trace-Id"] = request["trace_id"]
        raise
    except Exception as exc:  # noqa: BLE001 — boundary conversion
        log.exception("unhandled error rid=%s %s %s", rid,
                      request.method, request.path)
        resp = _web.json_response(
            {"error": sanitize_error(exc)}, status=500)
    resp.headers["X-Request-ID"] = rid
    if request["trace_id"]:
        resp.headers["X-Trace-Id"] = request["trace_id"]
    return resp
