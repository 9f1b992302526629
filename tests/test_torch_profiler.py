"""The port's device profiler (``obs/profiler.py`` on ``torch.profiler``)
against the reference's contract (``tests/test_perf_observatory.py``'s
profiler cases): the init-safety refusal, exclusivity, clamping to
``VLOG_PROFILE_MAX_S``, containment of hostile labels, the bounded stop
by the session's own timer thread, the explicit stop writing a Chrome
trace, and the outcomes counter. On the CPU the session records CPU
activities; ops launched from another thread land in the trace."""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import pytest
import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.obs import profiler as prof_mod
from vlog_tpu_torch.obs.metrics import HAVE_PROMETHEUS, runtime
from vlog_tpu_torch.obs.profiler import DeviceProfiler


@pytest.fixture
def root(monkeypatch, tmp_path):
    monkeypatch.setattr(config, "PROFILE_DIR", str(tmp_path / "prof"))
    return tmp_path / "prof"


def _count(outcome: str) -> float:
    return runtime().profile_sessions.labels(outcome)._value.get() \
        if HAVE_PROMETHEUS else 0.0


def test_refuses_when_cuda_is_not_initialized(root, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    before = _count("rejected")
    out = DeviceProfiler().start(duration_s=5)
    assert "error" in out and "CUDA is not initialized" in out["error"]
    assert not root.exists()
    if HAVE_PROMETHEUS:
        assert _count("rejected") == before + 1


def test_start_stop_containment_and_exclusivity(root):
    p = DeviceProfiler()
    started = _count("started")
    info = p.start(duration_s=30.0, label="../../../etc/passwd x")
    try:
        assert info.get("profiling") is True, info
        target = Path(info["dir"]).resolve()
        # a hostile label stays inside the artifact root
        assert target.is_relative_to(root.resolve())
        assert "/" not in target.name and " " not in target.name
        # exclusive: a second start is rejected, not queued
        again = p.start(duration_s=5)
        assert "already active" in again["error"]
        st = p.status()
        assert st["profiling"] is True and st["remaining_s"] <= 30.0
        torch.ones(64).sum()
    finally:
        out = p.stop()
    assert out["profiling"] is False and out.get("error") is None
    trace = json.loads(Path(out["trace"]).read_text())
    assert any(e.get("name") == "aten::sum" for e in trace["traceEvents"])
    assert "no active session" in p.stop()["error"]      # idempotent
    assert target.name in p.list_sessions()
    if HAVE_PROMETHEUS:
        assert _count("started") == started + 1


@pytest.mark.parametrize("asked,want", [(0.2, 1.0), (None, 2.0),
                                        ("bogus", 2.0), (5.0, 2.0),
                                        (1.5, 1.5)])
def test_duration_clamps(root, monkeypatch, asked, want):
    """Durations clamp to [1 s, VLOG_PROFILE_MAX_S]; a missing or bad one
    takes 10 s (then the cap)."""
    monkeypatch.setattr(config, "PROFILE_MAX_S", 2.0)
    p = DeviceProfiler()
    info = p.start(duration_s=asked)
    try:
        assert info["duration_s"] == want
    finally:
        p.stop()


def test_timer_stops_the_session_and_records_other_threads(root):
    """The session's own thread stops it when the duration ends, and ops
    run on another thread during the session are in the trace."""
    p = DeviceProfiler()
    completed = _count("completed")
    info = p.start(duration_s=1.0)
    assert info.get("profiling") is True, info

    def job():
        for _ in range(5):
            torch.arange(32).cumsum(0)

    th = threading.Thread(target=job, name="vlog-job-test")
    th.start()
    th.join()
    deadline = time.monotonic() + 10.0
    while p.status()["profiling"] and time.monotonic() < deadline:
        time.sleep(0.05)
    assert p.status()["profiling"] is False
    trace = json.loads((Path(info["dir"]) / prof_mod.TRACE_NAME).read_text())
    assert any(e.get("name") == "aten::cumsum" for e in trace["traceEvents"])
    assert "no active session" in p.stop()["error"]
    if HAVE_PROMETHEUS:
        assert _count("completed") == completed + 1
    assert not [t for t in threading.enumerate()
                if t.name == "vlog-profiler-stop"]


def test_profile_root_default_and_singleton(monkeypatch, tmp_path):
    monkeypatch.setattr(config, "PROFILE_DIR", "")
    monkeypatch.setattr(config, "BASE_DIR", tmp_path / "base")
    assert prof_mod.profile_root() == tmp_path / "base" / "profiles"
    assert DeviceProfiler().list_sessions() == []
    a = prof_mod.profiler()
    assert prof_mod.profiler() is a
    prof_mod.reset_profiler()
    assert prof_mod.profiler() is not a
    prof_mod.reset_profiler()
