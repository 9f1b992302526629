"""The port's observability copies and its compile meter.

- ``obs/trace.py`` against the JAX package's: the same stage keys, and
  ``record_run_stages`` folds the same ``stage_s`` into the same span
  names, durations and parent attributes.
- ``obs/metrics.py``: ``RuntimeMetrics.observe_run`` feeds the stage and
  rung histograms and the pipeline gauges as the reference's does, under
  the reference's family names; failpoint fires are counted.
- ``parallel/compile_cache.py``: the build directory
  (``VLOG_COMPILE_CACHE_DIR`` or the package's ``_build/``), and
  ``compile_seconds()``, which meters a cold build and stays put on a
  warm one.
Tolerance: exact (durations are the dict's numbers)."""

from __future__ import annotations

from pathlib import Path

import pytest

from vlog_tpu.obs import metrics as jmetrics
from vlog_tpu.obs import trace as jtrace
from vlog_tpu_torch import config as tconfig
from vlog_tpu_torch.obs import metrics as tmetrics
from vlog_tpu_torch.obs import trace as ttrace
from vlog_tpu_torch.parallel import compile_cache

STAGE_S = {"decode_wait_s": 0.5, "compute_wait_s": 1.25,
           "device_pull_s": 0.125, "entropy_s": 2.0, "package_s": 0.25,
           "pad_frames": 6.0, "rung_360p_s": 1.5, "rung_1080p_s": 3.0,
           "pipeline_depth": 2, "max_in_flight": 2, "host_busy_s": 2.375,
           "host_wall_s": 2.0, "host_occupancy": 1.188}


def test_stage_keys_match():
    assert ttrace.STAGE_KEYS == jtrace.STAGE_KEYS


@pytest.mark.parametrize("stage_s", [STAGE_S, {}, None,
                                     {"entropy_s": 1.0, "rung_a_s": 0.5}])
def test_record_run_stages_matches(stage_s):
    got = []
    for mod in (jtrace, ttrace):
        buf = mod.TraceBuffer()
        with mod.attach(mod.TraceContext("t" * 16, None, buf)):
            with mod.span("worker.transcode", job=7) as parent:
                mod.record_run_stages(parent, stage_s)
        spans = sorted(buf.drain(), key=lambda s: s.name)
        got.append([(s.name, s.duration_s if s.name != "worker.transcode"
                     else None, s.status,
                     {k: v for k, v in s.attrs.items()}) for s in spans])
    assert got[0] == got[1]


def test_span_error_and_event_without_buffer_match():
    for mod in (jtrace, ttrace):
        buf = mod.TraceBuffer()
        with mod.attach(mod.TraceContext("a" * 16, None, buf)):
            with pytest.raises(ValueError):
                with mod.span("boom"):
                    raise ValueError("x")
        (sp,) = buf.drain()
        assert sp.status == "error" and sp.attrs["error"] == "ValueError: x"
        assert mod.event("nothing collecting") is None


def _sample(reg, name: str, labels: dict) -> float | None:
    for fam in reg.collect():
        for s in fam.samples:
            if s.name == name and s.labels == labels:
                return s.value
    return None


@pytest.mark.skipif(not tmetrics.HAVE_PROMETHEUS,
                    reason="prometheus_client is not installed")
def test_observe_run_matches_the_reference():
    jm, tm = jmetrics.RuntimeMetrics(), tmetrics.RuntimeMetrics()
    for m in (jm, tm):
        m.observe_run(STAGE_S)
        m.observe_run(None)
    checks = [("vlog_stage_duration_seconds_sum", {"stage": "entropy"}),
              ("vlog_stage_duration_seconds_count", {"stage": "compute_wait"}),
              ("vlog_rung_duration_seconds_sum", {"rung": "1080p"}),
              ("vlog_pipeline_gauge", {"name": "host_occupancy"}),
              ("vlog_pipeline_gauge", {"name": "pad_frames"}),
              ("vlog_pipeline_gauge", {"name": "max_in_flight"})]
    for name, labels in checks:
        want = _sample(jm.registry, name, labels)
        assert want is not None
        assert _sample(tm.registry, name, labels) == want
    # the port's families are a subset of the reference's, same names
    jnames = {f.name for f in jm.registry.collect()}
    tnames = {f.name for f in tm.registry.collect()}
    assert tnames <= jnames
    assert {"vlog_mesh_slots", "vlog_device_seconds", "vlog_ladder_pad_waste",
            "vlog_asr_batches", "vlog_profile_sessions",
            "vlog_device_probe"} <= tnames


def test_failpoint_fires_are_counted():
    from vlog_tpu_torch.utils import failpoints

    m = tmetrics.runtime()
    before = _sample(m.registry, "vlog_failpoint_fires_total",
                     {"site": "backend.entropy"}) or 0.0
    failpoints.arm("backend.entropy", count=1)
    try:
        with pytest.raises(failpoints.FailpointError):
            failpoints.hit("backend.entropy")
    finally:
        failpoints.reset()
    if tmetrics.HAVE_PROMETHEUS:
        assert _sample(m.registry, "vlog_failpoint_fires_total",
                       {"site": "backend.entropy"}) == before + 1


def test_build_dir_default_and_explicit(monkeypatch, tmp_path):
    monkeypatch.setattr(tconfig, "COMPILE_CACHE_DIR", "")
    assert compile_cache.build_dir() == \
        Path(compile_cache.__file__).resolve().parent.parent / "_build"
    monkeypatch.setattr(tconfig, "COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    assert compile_cache.ensure_compile_cache() == str(tmp_path / "cc")
    assert (tmp_path / "cc").is_dir()


def test_compile_seconds_meters_cold_builds_only(monkeypatch, tmp_path):
    """A cold build directory costs the compiler's seconds; the same
    library again costs nothing."""
    from vlog_tpu_torch.native import build

    monkeypatch.setattr(tconfig, "COMPILE_CACHE_DIR", str(tmp_path / "cc"))
    compile_cache.reset_for_tests()
    assert compile_cache.compile_seconds() == 0.0
    so = build._compile()
    assert so.parent == tmp_path / "cc" and so.is_file()
    cold = compile_cache.compile_seconds()
    assert cold > 0.0
    assert build._compile() == so
    assert compile_cache.compile_seconds() == cold
    compile_cache.note_build(0.5)
    assert compile_cache.compile_seconds() == cold + 0.5
    compile_cache.reset_for_tests()
