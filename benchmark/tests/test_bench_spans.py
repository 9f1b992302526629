"""The readers of the program's per-unit records (``RunResult.dispatches``,
``AsrEngine.batch_log``) on synthetic runs: each value on a known record
set, and None when the records or the slice are missing (the parent
program keeps neither) or the profiled unit's shape differs from the
window's."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.harness import Window
from benchmark.trace import Slice

LADDER = ("executor.dispatch_wall_ms_per_frame",
          "executor.enqueue_ms_per_frame",
          "device.idle_pct.ladder_in_dispatch",
          "device.idle_pct.ladder_between_dispatches")
CAPTIONS = ("asr.step_wall_ms", "device.idle_pct.captions_in_tick",
            "device.idle_pct.captions_between_ticks")


def _read(name, run):
    return spec.load_reader(name)(run)


def _window(times):
    w = Window(100.0)
    for t in times:
        w.add(t, 1.0)
    return w


def _slice(busy_s: float, **meta) -> Slice:
    # two kernels, merged busy time busy_s
    half = busy_s * 1e6 / 2
    return Slice(kernels=[("k", 0.0, half), ("k", half, half)],
                 wall_s=3 * busy_s, meta=meta)


def _dispatch(done, wall, frames=144, enqueue=0.5):
    return {"index": 0, "frames": frames, "t_enqueue0": done - 2.0,
            "t_enqueue1": done - 2.0 + enqueue, "t_done": done,
            "wall_s": wall}


def _ladder(dispatches, sl=None, legacy=False):
    """Jobs finishing at t = 10, 20, 30, 40 (window span 10..40), one
    dispatch each done 1 s before its job's event."""
    jobs = []
    for k, rec in enumerate(dispatches):
        run = SimpleNamespace(frames_processed=rec["frames"])
        if not legacy:
            run.dispatches = [rec]
        jobs.append({"k": k, "result": SimpleNamespace(run=run)})
    jobs.append({"k": len(jobs), "stopped": True})       # the profiled job
    return SimpleNamespace(window=_window([10.0, 20.0, 30.0, 40.0]),
                           jobs=jobs, profiler=SimpleNamespace(slice=sl))


def test_ladder_readers_on_known_records():
    recs = [_dispatch(9.0, 7.0), _dispatch(19.0, 8.0), _dispatch(29.0, 9.0),
            _dispatch(39.0, 10.0)]
    run = _ladder(recs, _slice(6.0, frames=144, first=True))
    # the first job's dispatch is done before the window opens
    assert _read("executor.dispatch_wall_ms_per_frame", run) == \
        pytest.approx(1e3 * 27.0 / 432)
    assert _read("executor.enqueue_ms_per_frame", run) == \
        pytest.approx(1e3 * 1.5 / 432)
    inside = _read("device.idle_pct.ladder_in_dispatch", run)
    between = _read("device.idle_pct.ladder_between_dispatches", run)
    assert inside == pytest.approx(100 * (1 - (6.0 / 144) / (27.0 / 432)))
    assert between == pytest.approx(100 * (1 - 27.0 / 30.0))
    # the shares multiply to the busy time over the span
    assert (1 - inside / 100) * (1 - between / 100) == \
        pytest.approx(6.0 / 144 * 432 / 30.0)


def test_ladder_readers_without_records_or_slice():
    recs = [_dispatch(9.0 + 10 * i, 8.0) for i in range(4)]
    for name in LADDER:
        assert _read(name, _ladder(recs, _slice(6.0, frames=144),
                                   legacy=True)) is None, name
    assert _read("device.idle_pct.ladder_in_dispatch", _ladder(recs)) is None
    # no device clock (CPU): every wall is None
    cpu = [_dispatch(9.0 + 10 * i, None) for i in range(4)]
    run = _ladder(cpu, _slice(6.0, frames=144))
    for name in LADDER:
        want = None if name != "executor.enqueue_ms_per_frame" else \
            pytest.approx(1e3 * 1.5 / 432)
        assert _read(name, run) == want, name
    # an empty window
    run = _ladder(recs, _slice(6.0, frames=144))
    run.window = _window([10.0])
    for name in LADDER:
        assert _read(name, run) is None, name


def test_ladder_in_dispatch_needs_the_profiled_shape():
    recs = [_dispatch(9.0 + 10 * i, 8.0) for i in range(4)]
    assert _read("device.idle_pct.ladder_in_dispatch",
                 _ladder(recs, _slice(6.0, frames=72))) is None
    recs[2]["frames"] = 72
    assert _read("device.idle_pct.ladder_in_dispatch",
                 _ladder(recs, _slice(6.0, frames=144))) is None


def _tick(t1, wall, rows=16, steps=224):
    return {"rows": rows, "n": rows, "t0": t1 - 4.0, "t1": t1,
            "wall_s": wall, "steps": steps, "coalesce_s": 0.05,
            "lease_s": 0.0, "take_s": 0.001}


def _captions(log, sl=None, profiled_rows=16):
    """Ticks ending at t = 9.9, 13.9, 17.9, 21.9 (each event 0.1 s later;
    window span 10..22), then the profiled tick after the window."""
    ends = [9.9, 13.9, 17.9, 21.9]
    ticks = [{"t": t + 0.1, "rows": 16, "profiled": False} for t in ends]
    ticks.append({"t": 40.1, "rows": profiled_rows, "profiled": True})
    return SimpleNamespace(
        window=_window([t + 0.1 for t in ends]), ticks=ticks,
        prompt=[1, 2, 3], engine=SimpleNamespace(batch_log=log),
        profiler=SimpleNamespace(slice=sl))


def test_captions_readers_on_known_records():
    log = [_tick(9.9, 3.0), _tick(13.9, 3.2), _tick(17.9, 3.4),
           _tick(21.9, 3.3), _tick(40.0, 9.0)]
    run = _captions(log, _slice(2.9, windows=16))
    assert _read("asr.step_wall_ms", run) == pytest.approx(1e3 * 3.3 / 227)
    inside = _read("device.idle_pct.captions_in_tick", run)
    between = _read("device.idle_pct.captions_between_ticks", run)
    assert inside == pytest.approx(100 * (1 - 2.9 / 3.3))
    assert between == pytest.approx(100 * (1 - 9.9 / 12.0))
    assert (1 - inside / 100) * (1 - between / 100) == \
        pytest.approx(2.9 * 3 / 12.0, rel=0.05)


def test_captions_readers_without_records_or_slice():
    legacy = [{"rows": 16, "n": 16, "occupancy": 1.0, "jobs": [],
               "elapsed_s": 3.0} for _ in range(5)]
    for name in CAPTIONS:
        assert _read(name, _captions(legacy, _slice(2.9))) is None, name
    log = [_tick(t, 3.0) for t in (9.9, 13.9, 17.9, 21.9, 40.0)]
    assert _read("device.idle_pct.captions_in_tick", _captions(log)) is None
    cpu = [_tick(t, None) for t in (9.9, 13.9, 17.9, 21.9, 40.0)]
    for name in CAPTIONS:
        assert _read(name, _captions(cpu, _slice(2.9))) is None, name


def test_captions_in_tick_needs_the_profiled_shape():
    # the profiled tick ran 100 steps; no window tick did
    log = [_tick(t, 3.0) for t in (9.9, 13.9, 17.9, 21.9)]
    log.append(_tick(40.0, 9.0, steps=100))
    assert _read("device.idle_pct.captions_in_tick",
                 _captions(log, _slice(2.9))) is None
    # its rows differ from what the driver saw: not the profiled entry
    log[-1] = _tick(40.0, 9.0, rows=8)
    assert _read("device.idle_pct.captions_in_tick",
                 _captions(log, _slice(2.9))) is None
    # no profiled tick at all
    run = _captions(log[:4], _slice(2.9))
    run.ticks = [k for k in run.ticks if not k["profiled"]]
    assert _read("device.idle_pct.captions_in_tick", run) is None
