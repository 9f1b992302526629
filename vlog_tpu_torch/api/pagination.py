"""Keyset (cursor) pagination for large listings (a copy of
``vlog_tpu/api/pagination.py``).

Reference analog: api/pagination.py (99 LoC) — OFFSET pagination scans
and discards ``offset`` rows per page, degrading linearly; keyset
pagination seeks straight to the boundary with the composite index the
listing already uses. Cursors encode the last row's (sort timestamp,
id) as an opaque urlsafe-base64 token; id breaks timestamp ties, so
iteration is total and stable under concurrent inserts.

Timestamps here are the schema's epoch floats (db/core.py ``now()``),
not ISO datetimes — the token survives float round-tripping via
``repr``. Cursors only apply to the created_at-descending listings
(the same restriction the reference documents).
"""

from __future__ import annotations

import base64
import binascii

CURSOR_VERSION = "1"


class CursorError(ValueError):
    """Malformed or incompatible cursor token (client sends garbage)."""


def encode_cursor(ts: float, record_id: int) -> str:
    raw = f"{CURSOR_VERSION}|{ts!r}|{record_id}".encode()
    return base64.urlsafe_b64encode(raw).decode().rstrip("=")


def decode_cursor(token: str) -> tuple[float, int]:
    """Returns (timestamp, id); raises CursorError on any malformation."""
    try:
        pad = "=" * (-len(token) % 4)
        raw = base64.urlsafe_b64decode(token + pad).decode()
        version, ts_s, id_s = raw.split("|")
    except (binascii.Error, UnicodeDecodeError, ValueError) as exc:
        raise CursorError("malformed cursor") from exc
    if version != CURSOR_VERSION:
        raise CursorError(f"unsupported cursor version {version!r}")
    try:
        return float(ts_s), int(id_s)
    except ValueError as exc:
        raise CursorError("malformed cursor") from exc


def keyset_clause(ts_col: str = "created_at", id_col: str = "id",
                  *, param_prefix: str = "cur") -> str:
    """WHERE fragment for a created_at-DESC, id-DESC keyset page:
    rows strictly after the cursor position. Bind ``{prefix}_ts`` and
    ``{prefix}_id``."""
    return (f"({ts_col} < :{param_prefix}_ts OR "
            f"({ts_col} = :{param_prefix}_ts AND {id_col} < :{param_prefix}_id))")


def next_cursor_from(rows: list[dict], limit: int,
                     ts_col: str = "created_at", id_col: str = "id"
                     ) -> str | None:
    """Token for the next page, or None when this page was short (the
    natural end-of-listing signal)."""
    if len(rows) < limit or not rows:
        return None
    last = rows[-1]
    return encode_cursor(float(last[ts_col]), int(last[id_col]))
