"""On-demand, duration-bounded device profiling sessions (port of
``vlog_tpu/obs/profiler.py`` on ``torch.profiler``).

One session records ``torch.profiler`` activities (CPU ops of every
thread, and on a CUDA machine the card's kernels and copies through
CUPTI) and, when it stops, writes a Chrome trace (``trace.json``,
loadable in Perfetto or ``chrome://tracing``) into its directory under
``VLOG_PROFILE_DIR`` (default ``BASE_DIR/profiles``). Sessions are:

- **duration-bounded** — the requested duration clamps to
  ``VLOG_PROFILE_MAX_S``; the session runs on a daemon thread of its
  own that stops the trace when the duration ends, even if nobody asks
  again (the profiler must be started and stopped on one thread, so that
  thread is also the timer);
- **exclusive** — one active session per process (a second start is
  rejected, not queued);
- **contained** — session directories are created strictly inside the
  profile root (label characters are sanitized; the resolved path is
  verified under the resolved root before anything is written);
- **init-safe** — on a machine with CUDA, start refuses unless the
  process has already initialized CUDA: a management command must never
  pay for device initialization, and a process that has not touched the
  card has nothing worth profiling.

In-flight jobs keep running: their kernels, launched from their own
threads, are what the trace captures. Outcomes land in
``vlog_profile_sessions_total{outcome}``. The worker's ``profile``
command wires this in with the worker daemon.
"""

from __future__ import annotations

import logging
import re
import threading
import time
from pathlib import Path

import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.obs.metrics import runtime

log = logging.getLogger("vlog_tpu_torch.profiler")

_LABEL_RE = re.compile(r"[^a-zA-Z0-9_.-]+")
TRACE_NAME = "trace.json"


def profile_root() -> Path:
    """The artifact root (``VLOG_PROFILE_DIR`` or BASE_DIR/profiles)."""
    if config.PROFILE_DIR:
        return Path(config.PROFILE_DIR)
    return Path(config.BASE_DIR) / "profiles"


def _bump(outcome: str) -> None:
    runtime().profile_sessions.labels(outcome).inc()


class _Session:
    """One trace, started, waited on and stopped by its own thread."""

    def __init__(self, target: Path, duration_s: float, on_timeout):
        self.dir = target
        self.duration_s = duration_s
        self.started_at = 0.0
        self.error: str | None = None
        self._on_timeout = on_timeout
        self._stop = threading.Event()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="vlog-profiler-stop")

    def start(self) -> str | None:
        """Start the trace; returns an error message or None."""
        self._thread.start()
        self._started.wait()
        return self.error

    def stop(self) -> None:
        """Ask the session thread to stop now and wait for its export."""
        self._stop.set()
        self._thread.join()

    def _run(self) -> None:
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():  # meshshim-ok: which activities to trace, not a device choice
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities, experimental_config=
                           _ExperimentalConfig(profile_all_threads=True))
            prof.start()
        except Exception as exc:   # noqa: BLE001 — surfaced to start()
            self.error = f"{type(exc).__name__}: {exc}"
            self._started.set()
            return
        self.started_at = time.time()
        self._started.set()
        timed_out = not self._stop.wait(self.duration_s)
        try:
            prof.stop()
            prof.export_chrome_trace(str(self.dir / TRACE_NAME))
        except Exception as exc:   # noqa: BLE001 — reported by stop
            self.error = f"{type(exc).__name__}: {exc}"
            log.warning("profiler stop failed", exc_info=True)
        if timed_out:
            self._on_timeout(self)


class DeviceProfiler:
    """One process's profiling sessions (singleton via :func:`profiler`)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()             # lock-order: 39
        self._session: _Session | None = None     # guarded-by: _lock

    # ---- session lifecycle -------------------------------------------

    def start(self, duration_s: float | None = None,
              label: str = "") -> dict:
        """Start one bounded trace session; returns the session info or
        an ``{"error": ...}`` dict (command-channel style, never raises)."""
        if torch.cuda.is_available() and not torch.cuda.is_initialized():  # meshshim-ok: refuses a session with nothing on the card to trace; chooses no device
            _bump("rejected")
            return {"error": "CUDA is not initialized in this process; "
                             "nothing to profile (run a job first)"}
        try:
            dur = float(duration_s) if duration_s else 10.0
        except (TypeError, ValueError):
            dur = 10.0
        dur = max(1.0, min(dur, config.PROFILE_MAX_S))
        root = profile_root().resolve()
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
        name = f"{stamp}-{_LABEL_RE.sub('_', label)[:48]}" if label \
            else stamp
        target = (root / name).resolve()
        if root not in target.parents and target != root:
            _bump("rejected")
            return {"error": "profile label escapes the artifact root"}
        with self._lock:
            if self._session is not None:
                _bump("rejected")
                return {"error": "a profiling session is already active",
                        "active": self._status_locked()}
            target.mkdir(parents=True, exist_ok=True)
            session = _Session(target, dur, self._timed_out)
            err = session.start()
            if err is not None:
                _bump("error")
                log.warning("profiler start failed: %s", err)
                return {"error": f"profiler start failed: {err}"}
            self._session = session
        _bump("started")
        log.info("profiling session started: %s (%.1fs)", target, dur)
        return {"profiling": True, "dir": str(target),
                "duration_s": dur, "started_at": session.started_at}

    def stop(self) -> dict:
        """Stop the active session early and write its trace
        (idempotent)."""
        with self._lock:
            session, self._session = self._session, None
        if session is None:
            return {"profiling": False, "error": "no active session"}
        session.stop()
        return self._finish(session, "explicit")

    def _timed_out(self, session: _Session) -> None:
        """The session thread's own end: clears the session unless an
        explicit stop already took it."""
        with self._lock:
            if self._session is not session:
                return
            self._session = None
        self._finish(session, "timer")

    @staticmethod
    def _finish(session: _Session, source: str) -> dict:
        if session.error is not None:
            _bump("error")
            return {"profiling": False, "dir": str(session.dir),
                    "error": f"profiler stop failed (session cleared): "
                             f"{session.error}"}
        _bump("completed")
        log.info("profiling session stopped (%s): %s", source, session.dir)
        return {"profiling": False, "dir": str(session.dir),
                "trace": str(session.dir / TRACE_NAME),
                "elapsed_s": round(time.time() - session.started_at, 2)}

    # ---- status ------------------------------------------------------

    def _status_locked(self) -> dict:
        s = self._session
        if s is None:
            return {"profiling": False}
        return {"profiling": True, "dir": str(s.dir),
                "started_at": s.started_at, "duration_s": s.duration_s,
                "remaining_s": round(max(
                    0.0, s.started_at + s.duration_s - time.time()), 2)}

    def status(self) -> dict:
        with self._lock:
            info = self._status_locked()
        info["root"] = str(profile_root())
        info["sessions"] = self.list_sessions()
        return info

    def list_sessions(self) -> list[str]:
        """Artifact directories currently on disk (newest first)."""
        root = profile_root()
        if not root.is_dir():
            return []
        return sorted((p.name for p in root.iterdir() if p.is_dir()),
                      reverse=True)[:32]


_profiler: DeviceProfiler | None = None
_profiler_lock = threading.Lock()


def profiler() -> DeviceProfiler:
    """The process-wide profiler (lazy singleton)."""
    global _profiler
    if _profiler is None:
        with _profiler_lock:
            if _profiler is None:
                _profiler = DeviceProfiler()
    return _profiler


def reset_profiler() -> None:
    """Stop any active session and drop the singleton."""
    global _profiler
    with _profiler_lock:
        if _profiler is not None:
            _profiler.stop()
        _profiler = None
