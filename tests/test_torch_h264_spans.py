"""The H.264 ladder's device-clock dispatch records and stage spans
(``TorchBackend.run``'s H.264 branch, ``parallel/ladder.py``'s chain
step, ``codecs/h264/inter.py``), on the CPU: a run keeps one
``timed_dispatch`` record a dispatch (host times; ``wall_s`` None without
CUDA), its spans land among a profiler session's host events nested as
the code nests, and README's port section names every span."""

from __future__ import annotations

# slowlane-ok(module): one 48x64 H.264 run of 24 frames, plain and under
# a CPU profiler session (a few seconds each on one thread).

import ast
from pathlib import Path

import pytest

from tests.fixtures.media import make_y4m
from tests.test_torch_backend import one_torch_thread  # noqa: F401
from tests.test_torch_spans import _host_events, _inside, _named, _session

ROOT = Path(__file__).resolve().parents[1]
H264_SPANS = ("executor.decode_wait", "executor.reserve", "executor.plan",
              "executor.dispatch", "executor.submit", "h264.rung",
              "h264.resize", "h264.intra", "h264.p_frame", "h264.me",
              "h264.residual", "h264.deblock", "h264.rc")


@pytest.fixture(scope="module")
def h264_runs(tmp_path_factory):
    """The same 24-frame 48x64 H.264 run (two 12-frame dispatches of two
    6-frame chains, two rungs, rate control and deblocking on) plain and
    under a CPU profiler session on the calling thread: (plain RunResult,
    profiled RunResult, host events)."""
    from vlog_tpu_torch import config as tconfig
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info

    root = tmp_path_factory.mktemp("spans_h264")
    src = make_y4m(root / "src.y4m", n_frames=24, width=64, height=48,
                   fps=6, seed=4)
    rungs = (tconfig.QualityRung("48p", 48, 150_000, 0, base_qp=30),
             tconfig.QualityRung("32p", 32, 75_000, 0, base_qp=31))
    be = TorchBackend(device="cpu")

    def run(out: Path):
        plan = be.plan(get_video_info(src), rungs, out, codec="h264",
                       segment_duration_s=1.0, frame_batch=12)
        return be.run(plan, None, resume=False)

    plain = run(root / "plain")
    with _session() as prof:
        traced = run(root / "traced")
    return plain, traced, _host_events(prof)


def test_run_h264_keeps_a_record_per_dispatch(h264_runs):
    for res in h264_runs[:2]:
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


def test_run_h264_stage_spans_nest_on_the_dispatch_thread(h264_runs):
    events = h264_runs[2]
    spans = {name: _named(events, name) for name in H264_SPANS}
    assert all(spans.values()), [n for n, v in spans.items() if not v]
    assert len(spans["executor.dispatch"]) == 2
    assert len(spans["h264.rung"]) == 4                 # 2 dispatches x 2
    assert len(spans["h264.intra"]) == 4
    assert len(spans["h264.p_frame"]) == 2 * 2 * 5      # 6-frame chains
    assert len(spans["h264.me"]) == len(spans["h264.residual"]) == 20
    assert len(spans["h264.deblock"]) == 4 + 20         # I and P frames
    nest = [("h264.rung", "executor.dispatch"), ("h264.resize", "h264.rung"),
            ("h264.intra", "h264.rung"), ("h264.p_frame", "h264.rung"),
            ("h264.deblock", "h264.rung"), ("h264.rc", "h264.rung"),
            ("h264.me", "h264.p_frame"), ("h264.residual", "h264.p_frame")]
    for inner, outer in nest:
        assert all(_inside(iv, spans[outer]) for iv in spans[inner]), inner
    # the I frame's filter is outside its intra span, a P frame's inside
    # its P frame
    in_p = [iv for iv in spans["h264.deblock"]
            if _inside(iv, spans["h264.p_frame"])]
    assert len(in_p) == 20
    assert not any(_inside(iv, spans["h264.intra"])
                   for iv in spans["h264.deblock"])


def test_run_h264_outputs_do_not_depend_on_the_session(h264_runs):
    plain, traced, _ = h264_runs
    assert [(r.name, r.achieved_bitrate, r.segment_count)
            for r in plain.rungs] == [(r.name, r.achieved_bitrate,
                                       r.segment_count) for r in traced.rungs]


def _stage_names(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) == "stage" \
                and node.args and isinstance(node.args[0], ast.Constant):
            out.add(node.args[0].value)
    return out


def test_readme_names_every_h264_span():
    pkg = ROOT / "vlog_tpu_torch"
    names = set()
    for rel in ("backends/torch_backend.py", "backends/ladder_run.py",
                "parallel/ladder.py", "codecs/h264/inter.py"):
        names |= _stage_names(pkg / rel)
    assert names == set(H264_SPANS)
    readme = (ROOT / "README.md").read_text()
    port = readme[readme.index("**Device-clock records and stage spans**"):]
    for name in names:
        assert f"`{name}`" in port, name


def test_the_registry_pass_stays_clean():
    from vlog_tpu_torch.analysis.__main__ import main

    # the package's baselined findings only
    assert main(["--rule", "registry"]) == 0
