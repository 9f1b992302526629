"""``TorchBackend(device="cpu")`` on the device runtime: the executor at
``VLOG_PIPELINE_DEPTH`` 1, 2 and 3, its failpoints, and slot leases.

Source: ``make_y4m``'s 96x128 Y4M at 10 fps, 1 s segments, rungs 96p
(identity) and 64p (scaled) at constant QP (``video_bitrate`` 0), no
thumbnail. Constant QP makes the trees depth-invariant by contract (rate
control's feedback lag is the depth, so under it depths may differ).

- Intra-only (5 dispatches of 8 frames): the port's trees at depths 1, 2
  and 3 are byte-identical to each other (the journal aside: its header
  records the depth) and to ``JaxBackend``'s at the same depth (journal
  included, ``cost`` None), JAX pinned to one device by patching
  ``vlog_tpu.parallel.scheduler.grid_for_run``; ``stage_s`` has the
  reference's keys.
- H.264 I+P chains and HEVC chains the same way, in the slow lane.
- ``backend.pull`` / ``backend.entropy`` armed once mid-run: the run
  raises, no executor or prefetch thread is left, and the resumed run
  writes the uninterrupted tree.
- Under a port slot lease one device wide the run executes on the
  lease's device (here the CPU) and writes the same tree; under a lease
  of two devices (the default ``VLOG_TPU_MESH``: a 2x1 grid) the run
  splits its chains over both and writes the same tree too.
Tolerance: byte-identical files (the journal's ``cost`` within rtol
1e-5, ``tests/test_torch_backend.py::assert_journals_match``).
"""

from __future__ import annotations

import threading
from pathlib import Path

import pytest
import torch

from tests.fixtures.media import make_y4m
from tests.test_torch_backend import (_files, assert_same_files,  # noqa: F401
                                      one_torch_thread)

JOURNAL = "rc_journal.jsonl"
DEPTHS = (1, 2, 3)


def const_rungs(codec_pkg):
    spec = (("96p", 96, 30), ("64p", 64, 31))
    return tuple(codec_pkg.QualityRung(n, h, 0, 0, base_qp=q)
                 for n, h, q in spec)


@pytest.fixture(scope="module")
def src40(tmp_path_factory) -> Path:
    return make_y4m(tmp_path_factory.mktemp("rt") / "src.y4m", n_frames=40,
                    width=128, height=96, fps=10)


@pytest.fixture
def depth_of(monkeypatch):
    """Set both packages' VLOG_PIPELINE_DEPTH."""
    from vlog_tpu import config as jconfig
    from vlog_tpu_torch import config as tconfig

    def set_depth(depth: int) -> None:
        monkeypatch.setattr(jconfig, "PIPELINE_DEPTH", depth)
        monkeypatch.setattr(tconfig, "PIPELINE_DEPTH", depth)
    return set_depth


@pytest.fixture
def single_device(monkeypatch):
    from vlog_tpu.parallel import scheduler

    monkeypatch.setattr(scheduler, "grid_for_run", lambda *a, **k: None)


def _torch_run(src, out, progress_cb=None, resume=False, **opts):
    from vlog_tpu_torch import config
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info

    be = TorchBackend(device="cpu")
    plan = be.plan(get_video_info(src), const_rungs(config), out,
                   segment_duration_s=1.0, thumbnail=False, **opts)
    return be.run(plan, progress_cb, resume=resume)


def _jax_run(src, out, **opts):
    from vlog_tpu import config
    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu.media.probe import get_video_info

    be = JaxBackend()
    plan = be.plan(get_video_info(src), const_rungs(config), out,
                   segment_duration_s=1.0, thumbnail=False, **opts)
    return be.run(plan, resume=False)


def _published(root: Path) -> dict[str, bytes]:
    return {k: v for k, v in _files(root).items() if k != JOURNAL}


def _depth_sweep(src, tmp_path, depth_of, n_frames, **opts):
    """The port and JAX at each depth: equal trees per depth, one
    published tree across depths; returns the port's results."""
    ref, results = None, {}
    for depth in DEPTHS:
        depth_of(depth)
        jres = _jax_run(src, tmp_path / f"jax{depth}", **opts)
        tres = _torch_run(src, tmp_path / f"torch{depth}", **opts)
        assert tres.frames_processed == jres.frames_processed == n_frames
        assert_same_files(tmp_path / f"jax{depth}", tmp_path / f"torch{depth}")
        # the reference's keys and the port's device-clock dispatch sums
        extra = {"enqueue_s", "dispatch_wall_s"}
        assert set(tres.stage_s) == set(jres.stage_s) | extra
        assert tres.stage_s["pipeline_depth"] == depth
        assert 1 <= tres.stage_s["max_in_flight"] <= depth
        tree = _published(tmp_path / f"torch{depth}")
        assert sum(k.endswith(".m4s") for k in tree) == 2 * (n_frames // 10)
        if ref is None:
            ref = tree
        assert tree == ref, f"depth {depth} differs from depth 1"
        results[depth] = tres
    return results


def test_intra_depths_equal_each_other_and_jax(src40, tmp_path, depth_of,
                                               single_device):
    results = _depth_sweep(src40, tmp_path, depth_of, 40, gop_mode="intra")
    assert results[1].stage_s["max_in_flight"] == 1
    from vlog_tpu_torch.obs.trace import STAGE_KEYS

    for res in results.values():
        assert set(STAGE_KEYS) <= set(res.stage_s)
        assert {"rung_96p_s", "rung_64p_s", "pad_frames"} <= set(res.stage_s)


@pytest.mark.slow
def test_h264_chain_depths_equal_each_other_and_jax(tmp_path, depth_of,
                                                    single_device):
    src = make_y4m(tmp_path / "src.y4m", n_frames=20, width=128, height=96,
                   fps=10)
    _depth_sweep(src, tmp_path, depth_of, 20)


@pytest.mark.slow
def test_hevc_chain_depths_equal_each_other_and_jax(tmp_path, depth_of,
                                                    single_device):
    """HEVC at constant QP on the seed whose scaled rung resizes alike in
    both packages (tests/test_torch_hevc_backend.py)."""
    src = make_y4m(tmp_path / "src.y4m", n_frames=20, width=128, height=96,
                   fps=10, seed=4)
    _depth_sweep(src, tmp_path, depth_of, 20, codec="h265")


def _leaked() -> list[str]:
    return [t.name for t in threading.enumerate() if t.is_alive()
            and t.name.startswith(("vlog-pipe", "vlog-decode"))]


@pytest.mark.parametrize("site", ["backend.pull", "backend.entropy"])
def test_failpoint_drains_clean_and_resumes(src40, tmp_path, depth_of, site):
    """Armed on its third hit (the 64p rung's batch 1 or the 96p rung's,
    whichever consumer gets there second): the run raises, nothing is
    left running, and the resumed run writes the uninterrupted tree."""
    from vlog_tpu_torch.utils import failpoints

    depth_of(2)
    whole = _torch_run(src40, tmp_path / "whole", gop_mode="intra")
    failpoints.reset()
    failpoints.arm(site, count=1, skip=2)
    try:
        with pytest.raises(failpoints.FailpointError):
            _torch_run(src40, tmp_path / "cut", gop_mode="intra")
        assert failpoints.counters()[site]["fires"] == 1
    finally:
        failpoints.reset()
    assert not _leaked()
    res = _torch_run(src40, tmp_path / "cut", resume=True, gop_mode="intra")
    assert res.frames_processed == whole.frames_processed == 40
    assert_same_files(tmp_path / "whole", tmp_path / "cut")


def test_progress_callback_failure_stops_the_run(src40, tmp_path, depth_of):
    """An ``on_batch_done`` hook that raises (the progress callback) ends
    the run through the executor, like a stage failure."""
    depth_of(3)

    class Stop(Exception):
        pass

    def stop(done, total, msg):
        if done >= 16:
            raise Stop(msg)

    with pytest.raises(Stop):
        _torch_run(src40, tmp_path / "cut", progress_cb=stop, gop_mode="intra")
    assert not _leaked()


def test_width_one_lease_runs_on_its_device_with_the_same_tree(
        src40, tmp_path, depth_of):
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler

    depth_of(2)
    _torch_run(src40, tmp_path / "plain", gop_mode="intra")
    sched = MeshScheduler(devices=[torch.device("cpu")], slots=1)
    ticket = sched.admit()
    with ticket.acquire() as lease:
        res = _torch_run(src40, tmp_path / "leased", gop_mode="intra")
        assert lease.shape == "1x1"
    ticket.close()
    assert res.frames_processed == 40 and sched.capacity() == 1
    assert _files(tmp_path / "leased") == _files(tmp_path / "plain")


@pytest.mark.parametrize("codec", ["h264", "h265"])
def test_wider_lease_raises_before_writing(src40, tmp_path, codec,
                                           depth_of):
    """A lease of two devices runs the ladder as its 2x1 grid (chains
    split over both) and writes the one-device tree; the journal, shaped
    by the grid's batch, aside (H.264: 10-frame chains, 2 per dispatch
    on the grid, 1 without)."""
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler

    depth_of(2)
    _torch_run(src40, tmp_path / "plain", codec=codec)
    sched = MeshScheduler(devices=[torch.device("cpu", 0),
                                   torch.device("cpu", 1)], slots=1)
    ticket = sched.admit()
    with ticket.acquire() as lease:
        res = _torch_run(src40, tmp_path / "wide", codec=codec)
        assert lease.shape == "2x1"
    ticket.close()
    assert res.frames_processed == 40 and sched.capacity() == 1
    plain, wide = _files(tmp_path / "plain"), _files(tmp_path / "wide")
    plain.pop(JOURNAL, None)
    wide.pop(JOURNAL, None)
    assert wide == plain


def test_process_video_under_a_lease(src40, tmp_path):
    """``process_video`` on a width-1 lease: the same verified tree as
    without one."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler
    from vlog_tpu_torch.worker import process_video

    opts = dict(rungs=const_rungs(config), gop_mode="intra",
                segment_duration_s=1.0, thumbnail=False)
    plain = process_video(src40, tmp_path / "plain",
                          backend=TorchBackend(device="cpu"), **opts)
    sched = MeshScheduler(devices=[torch.device("cpu")], slots=1)
    ticket = sched.admit()
    with ticket.acquire():
        leased = process_video(src40, tmp_path / "leased",
                               backend=TorchBackend(device="cpu"), **opts)
    ticket.close()
    assert leased.qualities == plain.qualities
    files = {k: v for k, v in _files(tmp_path / "leased").items()
             if k != "outputs.json"}
    assert files == {k: v for k, v in _files(tmp_path / "plain").items()
                     if k != "outputs.json"}
