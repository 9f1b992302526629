"""Bounded in-memory ring of recent log records, per process (a copy of
``vlog_tpu/utils/logring.py``).

Reference parity: worker/command_listener.py:244-448 — the reference's
``get_logs`` command tails the worker's on-disk log file and ships the
last N lines back over the command channel. Containerized workers here
log to stdout (collected by the orchestrator), so the equivalent is an
in-process ring: a logging.Handler that keeps the last ``capacity``
formatted lines, cheap enough to leave attached always, queryable by
the command channel without touching disk.
"""

from __future__ import annotations

import collections
import logging
import threading

_FMT = logging.Formatter(
    "%(asctime)s %(levelname)s %(name)s: %(message)s")


class RingLogHandler(logging.Handler):
    """Keep the last ``capacity`` formatted log lines in memory."""

    def __init__(self, capacity: int = 2000,
                 level: int = logging.INFO) -> None:
        super().__init__(level)
        self.setFormatter(_FMT)
        self._lines: collections.deque[str] = collections.deque(
            maxlen=capacity)
        self._ring_lock = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            line = self.format(record)
        except Exception:   # noqa: BLE001 — a bad record must not recurse
            return
        with self._ring_lock:
            self._lines.append(line)

    def tail(self, n: int = 100, *,
             level: str | None = None) -> list[str]:
        """Last ``n`` lines, optionally only those at/above ``level``
        (matched on the formatted level token)."""
        with self._ring_lock:
            lines = list(self._lines)
        if level:
            want = level.upper()
            order = ["DEBUG", "INFO", "WARNING", "ERROR", "CRITICAL"]
            if want in order:
                allowed = set(order[order.index(want):])
                lines = [ln for ln in lines
                         if any(f" {lv} " in ln for lv in allowed)]
        return lines[-max(0, n):]


_installed: RingLogHandler | None = None
_install_lock = threading.Lock()


def install_ring(capacity: int = 2000) -> RingLogHandler:
    """Attach one ring to the root logger (idempotent per process)."""
    global _installed
    with _install_lock:
        if _installed is None:
            _installed = RingLogHandler(capacity)
            logging.getLogger().addHandler(_installed)
        return _installed
