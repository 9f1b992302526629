"""The ``h264-ladder`` cell on the CPU: the spec with its three cells, its
readers on synthetic slices and records (None where the program keeps
no H.264 spans or records, as before it had them), whole runs at a CPU
size with the timed path broken underneath (``correct`` false for each
fault, true with none), and what its driver and references import."""

from __future__ import annotations

import ast
import contextlib
import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness, spec
from benchmark import run as brun
from benchmark.harness import Window
from benchmark.trace import Slice

BENCH = Path(__file__).resolve().parents[1]
CELL = "h264-ladder.360p-clips"
SPAN_READERS = {"h264.intra_ms_per_frame": "h264.intra",
                "h264.me_ms_per_frame": "h264.me",
                "h264.deblock_ms_per_frame": "h264.deblock"}
READERS = ("h264.launches_per_frame", "h264.device_ms_per_frame",
           *SPAN_READERS, "h264.entropy_ms_per_frame",
           "device.idle_pct.h264_in_dispatch")


def _read(name, run):
    return spec.load_reader(name)(run)


# --------------------------------------------------------------------------
# the spec
# --------------------------------------------------------------------------

def test_the_spec_holds_the_h264_cell():
    good = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    spec.validate(good)
    assert [w["name"] for w in good["workloads"]] == [
        "hevc-ladder.1080p-clips", "whisper-small.backlog", CELL]
    cell = spec.cell(good, CELL)
    assert cell.chips == 1 and cell.config["driver"] == "h264_ladder"
    assert [m["name"] for m in cell.end_to_end] == ["ladder_fps", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == list(READERS)
    for m in cell.per_layer:
        assert m["moves"] == "ladder_fps" and m["workloads"] == [CELL]
    # the configuration is the default plan's on a 360p source
    cfg = cell.config
    assert cfg["codec"] == "h264" and cfg["gop"] == 24
    assert [(r["height"], r["width"], r["qp"], r["video_bitrate"])
            for r in cfg["rungs"]] == [(360, 640, 33, 600_000)]
    assert (cell.traffic["height"], cell.traffic["width"]) == (360, 640)
    entry = next(c for c in good["configs"] if c["name"] == "h264-ladder")
    assert entry["reduced"] == ["source_height"]


# --------------------------------------------------------------------------
# the readers
# --------------------------------------------------------------------------

def _slice(frames=144, spans=True) -> Slice:
    kernels = [("k", 0.0, 500.0), ("k", 1000.0, 500.0), ("k", 1200.0, 100.0)]
    host = [("aten::add", 0.0, 10.0)]
    if spans:
        host += [("h264.intra", 0.0, 3000.0), ("h264.intra", 5000.0, 1000.0),
                 ("h264.me", 10.0, 2000.0), ("h264.deblock", 20.0, 7200.0)]
    return Slice(kernels=kernels, host_ops=host, wall_s=0.01,
                 meta={"frames": frames, "first": False})


def _run(sl, records=True, frames=144):
    """Jobs finishing at t = 10 and 20 (the window's two events), a third
    stopped (the profiled one); each job one dispatch done 1 s before its
    event, its device wall 6 and 10 s."""
    jobs = []
    for k, t in enumerate((10.0, 20.0)):
        res = SimpleNamespace(frames_processed=frames,
                              stage_s={"entropy_s": 0.288 * (k + 1)})
        if records:
            res.dispatches = [{"index": 0, "frames": frames,
                               "t_enqueue0": t - 9.0, "t_enqueue1": t - 1.5,
                               "t_done": t - 1.0, "wall_s": 6.0 + 4.0 * k}]
        else:
            res.dispatches = []          # the RunResult field's default
        jobs.append({"k": k, "result": SimpleNamespace(run=res), "t1": t})
    jobs.append({"k": 2, "stopped": True})
    w = Window(51.0)
    w.add(10.0, frames)
    w.add(20.0, frames)
    return SimpleNamespace(window=w, jobs=jobs,
                           profiler=SimpleNamespace(slice=sl))


def test_h264_readers_on_a_known_slice():
    run = _run(_slice())
    assert _read("h264.launches_per_frame", run) == pytest.approx(3 / 144)
    assert _read("h264.device_ms_per_frame", run) == pytest.approx(1.1 / 144)
    assert _read("h264.intra_ms_per_frame", run) == pytest.approx(4.0 / 144)
    assert _read("h264.me_ms_per_frame", run) == pytest.approx(2.0 / 144)
    assert _read("h264.deblock_ms_per_frame", run) == pytest.approx(7.2 / 144)
    assert _read("h264.entropy_ms_per_frame", run) == \
        pytest.approx(1e3 * (0.288 + 0.576) / 288)
    # both jobs' records (the first job's dispatch done before the
    # window opens): 1.0 ms busy (the third kernel overlaps the second) a
    # 144-frame dispatch against 8 s on average
    assert _read("device.idle_pct.h264_in_dispatch", run) == \
        pytest.approx(100 * (1 - (1.0e-3 / 144) / (8.0 / 144)))


def test_h264_window_readers_do_not_need_two_events_in_the_window():
    # a traced run whose jobs outlast the window: one event inside it
    run = _run(_slice())
    run.window = Window(5.0)
    run.window.add(10.0, 144)
    run.window.add(20.0, 144)
    assert run.window.span is None
    assert _read("h264.entropy_ms_per_frame", run) == \
        pytest.approx(1e3 * (0.288 + 0.576) / 288)
    assert _read("device.idle_pct.h264_in_dispatch", run) == \
        pytest.approx(100 * (1 - (1.0e-3 / 144) / (8.0 / 144)))


@pytest.mark.parametrize("name", list(SPAN_READERS) +
                         ["device.idle_pct.h264_in_dispatch"])
def test_readers_of_new_spans_and_records_give_none_without_them(name):
    # the program before the H.264 path kept spans and records
    assert _read(name, _run(_slice(spans=False), records=False)) is None


@pytest.mark.parametrize("name", READERS)
def test_h264_readers_give_none_without_a_slice(name):
    if name == "h264.entropy_ms_per_frame":     # reads the ended jobs
        assert _read(name, _run(None)) is not None
        return
    assert _read(name, _run(None)) is None


def test_idle_reader_needs_the_profiled_dispatchs_frames():
    assert _read("device.idle_pct.h264_in_dispatch",
                 _run(_slice(frames=72))) is None


# --------------------------------------------------------------------------
# whole runs at a CPU size, with planted faults
# --------------------------------------------------------------------------

@pytest.fixture
def h264_root(tiny_root: Path) -> Path:
    """The benchmark copy with the H.264 cell cut to 48x64 clips of 48
    frames: two 24-frame chains, one dispatch a job."""
    cfg_p = tiny_root / "benchmark" / "configs" / "h264-ladder.json"
    cfg = json.loads(cfg_p.read_text())
    cfg["rungs"] = [{"name": "48p", "height": 48, "width": 64, "qp": 30,
                     "video_bitrate": 100000, "audio_bitrate": 64000}]
    cfg["source_height"] = 48
    cfg["env"] = dict(cfg["env"], VLOG_TPU_FRAME_BATCH="48",
                      VLOG_SEGMENT_DURATION="1")
    cfg_p.write_text(json.dumps(cfg))
    tr_p = tiny_root / "benchmark" / "traffic" / "360p-clips.json"
    tr = json.loads(tr_p.read_text())
    tr.update(height=48, width=64, frames=48)
    tr_p.write_text(json.dumps(tr))
    return tiny_root


def _alter_level(monkeypatch):
    from vlog_tpu_torch.parallel import ladder

    orig = ladder._one_rung

    def broken(*a, **kw):
        out = orig(*a, **kw)
        out["p_luma"][:, 3, 0, 0, 0, 0, 0, 0] += 1   # one P level a chain
        return out

    monkeypatch.setattr(ladder, "_one_rung", broken)


def _half_chains(monkeypatch):
    # half of each chain's frames left out: the second half repeats the
    # first half's frames
    from vlog_tpu_torch.parallel import ladder

    orig = ladder._one_rung

    def broken(y, u, v, *a, **kw):
        h = y.shape[1] // 2
        rep = lambda p: torch.cat([p[:, :h], p[:, :p.shape[1] - h]], 1)  # noqa: E731
        return orig(rep(y), rep(u), rep(v), *a, **kw)

    monkeypatch.setattr(ladder, "_one_rung", broken)


def _unfiltered(monkeypatch):
    # the in-loop filter left out: every frame's reconstruction unfiltered
    from vlog_tpu_torch.parallel import ladder

    monkeypatch.setattr(ladder, "deblock_frame",
                        lambda y, u, v, **kw: tuple(p.to(torch.int32)
                                                    for p in (y, u, v)))


def _drop_sample(monkeypatch):
    from vlog_tpu_torch.backends import torch_backend

    orig = torch_backend.media_segment
    monkeypatch.setattr(torch_backend, "media_segment",
                        lambda track, seq, base, chunk: orig(track, seq, base,
                                                             chunk[:-1]))


def _h264_control(monkeypatch):
    from benchmark.drivers import h264_ladder

    return h264_ladder.control()


@pytest.mark.parametrize("fault,number", [
    (None, None), (_alter_level, "dsp_mismatch"),
    (_half_chains, "dsp_mismatch"), (_unfiltered, "dsp_mismatch"),
    (_drop_sample, "tree_faults"), (_h264_control, "dsp_mismatch")])
def test_h264_ladder_run_judges(h264_root, monkeypatch, fault, number):
    torch.set_num_threads(2)
    args = brun.parse_args(["--workload", CELL, "--seed", "2147483905",
                            "--seconds", "6", "--trace", "0"])
    with contextlib.ExitStack() as stack:
        planted = fault(monkeypatch) if fault is not None else None
        if planted is not None:
            stack.enter_context(planted)
        result, checks = brun.run(args, device="cpu", root=h264_root)
    values = {c.name: c.value for c in checks}
    assert set(values) == {"dsp_mismatch", "tree_faults"}
    assert result["correct"] is (fault is None), values
    assert result["metrics"]["ladder_fps"]["value"] > 0
    if number:
        assert values[number] > 0


# --------------------------------------------------------------------------
# isolation
# --------------------------------------------------------------------------

def _imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("rel", [
    "drivers/h264_ladder.py", "reference/h264_core.py",
    "reference/h264_deblock.py", "reference/cmaf_avc.py",
    *(f"metrics/{n}.py" for n in READERS)])
def test_the_h264_cells_files_import_no_jax(rel):
    got = _imports(BENCH / rel)
    assert not got & set(harness.FORBIDDEN_MODULES), got
    if rel.startswith("reference/"):
        assert got <= {"__future__", "functools", "struct", "pathlib",
                       "numpy", "torch", "benchmark"}, got
        assert "vlog_tpu_torch" not in got
