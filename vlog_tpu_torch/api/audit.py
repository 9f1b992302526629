"""Security audit log: append-only JSONL with size rotation (a copy of
``vlog_tpu/api/audit.py``).

Reference parity: api/audit.py:251 (rotating security log,
config.py:492-499) — every mutating admin request is recorded with
timestamp, method, path, result, and caller address, rotated by size so
the log is bounded. Read-only requests are not logged (noise).
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

MAX_BYTES = 10 * 1024 * 1024
KEEP_ROTATIONS = 3


class AuditLog:
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()

    def _rotate_if_needed(self) -> None:
        try:
            if self.path.stat().st_size < MAX_BYTES:
                return
        except FileNotFoundError:
            return
        for i in range(KEEP_ROTATIONS - 1, 0, -1):
            src = self.path.with_suffix(f".{i}.log")
            if src.exists():
                os.replace(src, self.path.with_suffix(f".{i + 1}.log"))
        os.replace(self.path, self.path.with_suffix(".1.log"))

    def record(self, action: str, **fields) -> None:
        entry = {"ts": round(time.time(), 3), "action": action, **fields}
        line = json.dumps(entry, separators=(",", ":")) + "\n"
        with self._lock:
            self._rotate_if_needed()
            with open(self.path, "a") as fp:
                fp.write(line)
