"""DB-backed settings service with TTL cache and env fallback (a copy of
``vlog_tpu/api/settings.py``).

Reference parity: api/settings_service.py:48-1243 — dot-key settings
(``transcoding.segment_duration``) stored typed in the ``settings`` table,
read through an in-memory TTL cache (workers re-read every 60 s,
transcoder.py:113-202), falling back to ``VLOG_*`` environment variables
when a key has never been written.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any

from vlog_tpu_torch.db.core import Database, now as db_now

_TYPES = ("str", "int", "float", "bool", "json")


class SettingsError(ValueError):
    pass


def _type_of(value: Any) -> str:
    if isinstance(value, bool):
        return "bool"
    if isinstance(value, int):
        return "int"
    if isinstance(value, float):
        return "float"
    if isinstance(value, str):
        return "str"
    return "json"


def _encode(value: Any, value_type: str) -> str:
    if value_type == "json":
        return json.dumps(value)
    if value_type == "bool":
        return "true" if value else "false"
    return str(value)


def _decode(raw: str | None, value_type: str) -> Any:
    if raw is None:
        return None
    if value_type == "int":
        return int(raw)
    if value_type == "float":
        return float(raw)
    if value_type == "bool":
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if value_type == "json":
        return json.loads(raw)
    return raw


def env_name(key: str) -> str:
    """``transcoding.segment_duration`` -> ``VLOG_TRANSCODING_SEGMENT_DURATION``."""
    return "VLOG_" + key.upper().replace(".", "_").replace("-", "_")


class SettingsService:
    """Typed get/set over the settings table; values cached for ``ttl_s``."""

    def __init__(self, db: Database, *, ttl_s: float = 60.0):
        self.db = db
        self.ttl_s = ttl_s
        self._cache: dict[str, tuple[float, Any]] = {}

    def invalidate(self, key: str | None = None) -> None:
        if key is None:
            self._cache.clear()
        else:
            self._cache.pop(key, None)

    async def get(self, key: str, default: Any = None) -> Any:
        hit = self._cache.get(key)
        now = time.monotonic()
        if hit is not None and now - hit[0] < self.ttl_s:
            return hit[1]
        row = await self.db.fetch_one(
            "SELECT value, value_type FROM settings WHERE key=:k", {"k": key})
        if row is not None:
            value = _decode(row["value"], row["value_type"])
        else:
            raw = os.environ.get(env_name(key))
            value = raw if raw is not None else default
        self._cache[key] = (now, value)
        return value

    async def set(self, key: str, value: Any,
                  value_type: str | None = None) -> None:
        if not key or len(key) > 128 or any(
                not part for part in key.split(".")):
            raise SettingsError(f"bad settings key {key!r}")
        vt = value_type or _type_of(value)
        if vt not in _TYPES:
            raise SettingsError(f"bad value type {vt!r}")
        await self.db.execute(
            """
            INSERT INTO settings (key, value, value_type, updated_at)
            VALUES (:k, :v, :t, :now)
            ON CONFLICT (key) DO UPDATE SET value=:v, value_type=:t,
                updated_at=:now
            """,
            {"k": key, "v": _encode(value, vt), "t": vt, "now": db_now()})
        self._cache[key] = (time.monotonic(), _decode(_encode(value, vt), vt))

    async def delete(self, key: str) -> bool:
        n = await self.db.execute("DELETE FROM settings WHERE key=:k",
                                  {"k": key})
        self.invalidate(key)
        return bool(n)

    async def all(self) -> dict[str, Any]:
        rows = await self.db.fetch_all("SELECT * FROM settings ORDER BY key")
        return {r["key"]: _decode(r["value"], r["value_type"]) for r in rows}
