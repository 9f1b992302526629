"""The port's hot-path stage spans and device-clock unit records
(``vlog_tpu_torch/obs/trace.py::stage``/``DeviceClock``), on the CPU.

``stage()`` opens a profiler range only under a profiler session on the
calling thread, and nothing otherwise; under a session its names land
among the session's host events (operator-scope, so none on the device's
timeline), nested as the code nests. A tiny HEVC
ladder run and a tiny engine leave their per-dispatch and per-tick
records (host times; ``wall_s`` None without CUDA), and their thread
hand-offs carry the trace context (the ``tracehop`` rule).
"""

from __future__ import annotations

# slowlane-ok(module): one 96x128 HEVC run of 24 frames (~3 s on one
# thread) and tiny-checkpoint engine ticks (sub-second) back every test.

import threading
import tracemalloc
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.fixtures.media import make_y4m
from tests.test_torch_backend import one_torch_thread  # noqa: F401
from vlog_tpu_torch.obs import trace

LADDER_SPANS = ("executor.decode_wait", "executor.reserve", "executor.plan",
                "executor.dispatch", "executor.submit", "hevc.rung",
                "hevc.resize", "hevc.intra", "hevc.p_frame",
                "hevc.me.integer", "hevc.me.subpel", "hevc.residual",
                "hevc.deblock", "hevc.rc")
TICK_SPANS = ("asr.tick", "asr.mel", "asr.encode", "asr.cross_kv",
              "asr.prefill", "asr.step.rules", "asr.step.select",
              "asr.step.kv_gather", "asr.step.decoder", "asr.finish_check",
              "asr.pull", "asr.post")


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _host_events(prof) -> list[tuple[str, float, float]]:
    """(name, start_us, end_us) of every host event of the session."""
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        out.append((e.name(), s, s + e.duration_ns() / 1e3))
    return out


def _named(events, name: str) -> list[tuple[float, float]]:
    return [(s, e) for n, s, e in events if n == name]


def _inside(inner: tuple[float, float], outers) -> bool:
    return any(a <= inner[0] and inner[1] <= b for a, b in outers)


# --------------------------------------------------------------------------
# stage(): off, on, per thread
# --------------------------------------------------------------------------

def _count_ranges(monkeypatch) -> list:
    """Count every profiler range opened through either constructor."""
    calls = []
    for mod, attr in ((torch.profiler, "record_function"),
                      (torch._C._profiler, "_RecordFunctionFast")):
        real = getattr(mod, attr)
        monkeypatch.setattr(mod, attr, lambda *a, real=real, **k:
                            calls.append(a) or real(*a, **k))
    return calls


def test_stage_without_a_session_opens_no_range(monkeypatch):
    calls = _count_ranges(monkeypatch)
    assert not torch.autograd._profiler_enabled()
    first = trace.stage("hevc.rung")
    for _ in range(1000):
        with trace.stage("hevc.p_frame") as ctx:
            assert ctx is None
    # one shared no-op context: no object per call
    assert trace.stage("asr.tick") is first is trace.stage("x.y")
    assert calls == []


def test_stage_without_a_session_allocates_nothing():
    stage = trace.stage
    for _ in range(100):            # warm every lazy path first
        with stage("hevc.me.integer"):
            pass
    tracemalloc.start()
    try:
        before, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in range(20000):
            with stage("hevc.me.integer"):
                pass
        after, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert after - before < 512          # nothing retained
    assert peak - before < 512           # nothing allocated on the way


def test_stage_under_a_session_nests_as_the_code_nests(monkeypatch):
    calls = _count_ranges(monkeypatch)
    with _session() as prof:
        assert torch.autograd._profiler_enabled()
        with trace.stage("outer.unit"):
            torch.ones(64).mul_(2.0)
            with trace.stage("inner.step"):
                torch.ones(64).add_(1.0)
    assert calls == [("outer.unit",), ("inner.step",)]
    events = _host_events(prof)
    outer, inner = _named(events, "outer.unit"), _named(events, "inner.step")
    assert len(outer) == len(inner) == 1
    assert _inside(inner[0], outer)
    # the aten ops land inside the spans that launched them
    assert any(_inside((s, e), inner) for n, s, e in events
               if n == "aten::add_")


def test_stage_on_another_thread_is_not_recorded():
    seen = {}

    def other():
        seen["enabled"] = torch.autograd._profiler_enabled()
        with trace.stage("other.thread"):
            torch.ones(8).add_(1.0)

    with _session() as prof:
        with trace.stage("main.thread"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
    names = {n for n, _, _ in _host_events(prof)}
    assert seen == {"enabled": False}
    assert "main.thread" in names and "other.thread" not in names


def test_device_clock_reads_none_without_cuda():
    for devices in ((), ("cpu",), (torch.device("cpu"), "cpu:0")):
        clock = trace.DeviceClock(devices)
        clock.stop()
        assert clock.wall_s() is None


# --------------------------------------------------------------------------
# The ladder: per-dispatch records and spans on the dispatch thread
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hevc_runs(tmp_path_factory):
    """The same 24-frame 96x128 HEVC run (two 12-frame dispatches, rate
    control on) plain and under a CPU profiler session on the calling
    thread: (plain RunResult, profiled RunResult, host events)."""
    from vlog_tpu_torch import config as tconfig
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info

    root = tmp_path_factory.mktemp("spans_hevc")
    src = make_y4m(root / "src.y4m", n_frames=24, width=128, height=96,
                   fps=6, seed=4)
    rungs = (tconfig.QualityRung("96p", 96, 150_000, 0, base_qp=30),
             tconfig.QualityRung("64p", 64, 75_000, 0, base_qp=31))
    be = TorchBackend(device="cpu")

    def run(out: Path):
        plan = be.plan(get_video_info(src), rungs, out, codec="h265",
                       segment_duration_s=1.0)
        return be.run(plan, None, resume=False)

    plain = run(root / "plain")
    with _session() as prof:
        traced = run(root / "traced")
    return plain, traced, _host_events(prof)


def test_run_hevc_keeps_a_record_per_dispatch(hevc_runs):
    for res in hevc_runs[:2]:
        recs = res.dispatches
        assert [r["index"] for r in recs] == [0, 1]
        assert [r["frames"] for r in recs] == [12, 12]
        for r in recs:
            assert r["t_enqueue0"] < r["t_enqueue1"] <= r["t_done"]
            assert r["wall_s"] is None          # no device clock on the CPU
        assert recs[0]["t_enqueue1"] <= recs[1]["t_enqueue0"]   # in order
        assert res.stage_s["enqueue_s"] == pytest.approx(
            sum(r["t_enqueue1"] - r["t_enqueue0"] for r in recs), abs=2e-3)
        assert res.stage_s["dispatch_wall_s"] == 0.0


def test_run_hevc_stage_spans_nest_on_the_dispatch_thread(hevc_runs):
    events = hevc_runs[2]
    spans = {name: _named(events, name) for name in LADDER_SPANS}
    assert all(spans.values()), [n for n, v in spans.items() if not v]
    assert len(spans["executor.dispatch"]) == 2
    assert len(spans["hevc.rung"]) == 4                 # 2 dispatches x 2
    assert len(spans["hevc.p_frame"]) == 2 * 2 * 5      # 6-frame chains
    nest = [("hevc.rung", "executor.dispatch"), ("hevc.resize", "hevc.rung"),
            ("hevc.intra", "hevc.rung"), ("hevc.p_frame", "hevc.rung"),
            ("hevc.rc", "hevc.rung"), ("hevc.me.integer", "hevc.p_frame"),
            ("hevc.me.subpel", "hevc.p_frame"),
            ("hevc.residual", "hevc.p_frame"),
            ("hevc.deblock", "hevc.p_frame")]
    for inner, outer in nest:
        assert all(_inside(iv, spans[outer]) for iv in spans[inner]), inner
    # the consumer threads' entropy work is outside this thread's session
    assert not _named(events, "asr.tick")


def test_run_hevc_outputs_do_not_depend_on_the_session(hevc_runs):
    plain, traced, _ = hevc_runs
    assert [(r.name, r.achieved_bitrate, r.segment_count)
            for r in plain.rungs] == [(r.name, r.achieved_bitrate,
                                       r.segment_count) for r in traced.rungs]


# --------------------------------------------------------------------------
# The engine: per-tick records and spans on the tick thread
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def assets(tiny_model_dir):
    pytest.importorskip("transformers")
    from vlog_tpu_torch.asr import load as tload

    return tload.load_whisper(tiny_model_dir, device="cpu")


def _tone(seconds: float, freq: float) -> np.ndarray:
    t = np.arange(int(seconds * 16000)) / 16000
    return (0.25 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def test_engine_ticks_keep_their_records(assets):
    from vlog_tpu_torch.asr.engine import AsrEngine
    from vlog_tpu_torch.obs.metrics import HAVE_PROMETHEUS, runtime

    def device_seconds():
        for fam in runtime().registry.collect():
            for s in fam.samples:
                if s.name == "vlog_device_seconds_total" and \
                        s.labels == {"plane": "asr", "rung": "forward"}:
                    return s.value
        return 0.0

    before = device_seconds()
    engine = AsrEngine(assets, batch_windows=4, tick_s=0.05)
    try:
        h = engine.begin_job("A", language="en", max_new=12, beam=2)
        for i in range(6):
            h.submit(i, 25.0 * i, _tone(3.0, 220.0 + 40 * i))
        got = {idx for idx, _cues, _wait in h.results()}
        h.close()
    finally:
        engine.close()
    assert got == set(range(6))
    log = engine.batch_log
    assert [(b["n"], b["rows"]) for b in log] == [(4, 4), (2, 2)]
    for b in log:
        assert b["t0"] < b["t1"]
        assert b["wall_s"] is None
        assert 1 <= b["steps"] <= 12
        assert b["coalesce_s"] >= 0.04
        assert b["lease_s"] >= 0.0 and b["take_s"] >= 0.0
    assert log[0]["t1"] <= log[1]["t0"]
    if HAVE_PROMETHEUS:           # no device clock: nothing counted
        assert device_seconds() == before


def test_engine_tick_spans_under_a_session(assets):
    from vlog_tpu_torch.asr.engine import AsrEngine
    from vlog_tpu_torch.asr.queue import BatchKey, WorkItem

    engine = AsrEngine(assets, batch_windows=2, tick_s=0.0)
    key = BatchKey(language="en", task="transcribe", max_new=12, beam=2)
    items = [WorkItem(job="A", index=i, start_s=25.0 * i,
                      samples=_tone(3.0, 300.0 + 50 * i)) for i in range(2)]
    try:
        with _session() as prof:
            engine._tick(key, items, None)
    finally:
        engine.close()
    (entry,) = engine.batch_log
    events = _host_events(prof)
    spans = {name: _named(events, name) for name in TICK_SPANS}
    if entry["steps"] <= 8:          # the check runs every eighth step
        spans.pop("asr.finish_check")
    assert all(spans.values()), [n for n, v in spans.items() if not v]
    assert len(spans["asr.tick"]) == 1
    assert len(spans["asr.step.select"]) == entry["steps"]
    assert len(spans["asr.step.decoder"]) == entry["steps"] - 1
    for name, iv in spans.items():
        if name != "asr.tick":
            assert all(_inside(x, spans["asr.tick"]) for x in iv), name
    assert entry["coalesce_s"] == entry["lease_s"] == entry["take_s"] == 0.0


# --------------------------------------------------------------------------
# Thread hand-offs carry the trace context
# --------------------------------------------------------------------------

def test_tracehop_finds_nothing_in_the_executor_and_the_engine():
    from vlog_tpu_torch.analysis import core, tracehop

    pkg = Path(trace.__file__).resolve().parents[1]
    # the ladder run's dispatch loop hands batches to the executor
    mods = [m for m in core.load_package(pkg)
            if m.rel.endswith(("parallel/executor.py", "asr/engine.py",
                               "backends/ladder_run.py"))]
    assert len(mods) == 3
    assert all(tracehop._imports_trace(m) for m in mods)   # in scope
    assert tracehop.run(mods, pkg) == []


def test_executor_threads_run_under_the_callers_context():
    from vlog_tpu_torch.parallel.executor import DecodePrefetch, PipelineExecutor

    ctx = trace.TraceContext(trace_id="t" * 16, span_id="s" * 16)
    seen = []

    class Src:
        def read_batches(self, n, start):
            seen.append(("decode", trace.current()))
            yield np.zeros((1, 2, 2), np.uint8),

    with trace.attach(ctx):
        pipe = PipelineExecutor(
            ("a", "b"), pull=lambda name, batch: None,
            process=lambda name, batch, host: seen.append(
                (name, trace.current())), depth=1, host_threads=1)
        prefetch = DecodePrefetch(Src(), 1, 0)
        try:
            pipe.submit_aux(lambda: seen.append(("aux", trace.current())))
            pipe.reserve()
            pipe.submit(None, n_real=1)
            pipe.drain()
            assert prefetch.get() is not None and prefetch.get() is None
        finally:
            prefetch.close()
            pipe.close()
    assert sorted(n for n, _ in seen) == ["a", "aux", "b", "decode"]
    assert all(c is ctx for _, c in seen)
