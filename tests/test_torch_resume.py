"""Resume with the rate-control journal: TorchBackend(device="cpu") and
JaxBackend continuing each other's trees.

The tiny Y4M of tests/test_torch_backend.py, 40 frames at 10 fps: 1 s
segments, 10-frame chains, one chain per dispatch, so four dispatches of
one segment each, with rate control on (the controllers' state is what a
resume must restore). A ``progress_cb`` that raises after dispatch k
interrupts a run; the run with ``resume=True`` continues it. k = 1
resumes with nothing in flight; k = 3 at pipeline depth 2 resumes with
the observations of batches 1 and 2 posted but not applied, which
``LaggedRateControl.replay`` re-indexes.

Tolerance: a port tree that the port resumed equals the uninterrupted
port tree byte for byte, journal included. Across the two backends the
trees are byte-identical except the journal's float ``cost`` fields
(relative 1e-5, as in tests/test_torch_backend.py).
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from tests.fixtures.media import make_y4m
from tests.test_torch_backend import (JOURNAL, _files, assert_same_files,  # noqa: F401
                                      one_torch_thread, rung_pair)

N_FRAMES = 40
BITRATE = 150_000


class Interrupted(RuntimeError):
    pass


def _stop_after(k: int):
    def cb(done, total, msg):
        if done >= 10 * k:
            raise Interrupted(msg)
    return cb


@pytest.fixture(scope="module")
def source(tmp_path_factory) -> Path:
    return make_y4m(tmp_path_factory.mktemp("src") / "src.y4m",
                    n_frames=N_FRAMES, width=128, height=96, fps=10)


@pytest.fixture
def jax_single_device(monkeypatch):
    from vlog_tpu.parallel import scheduler

    monkeypatch.setattr(scheduler, "grid_for_run", lambda *a, **k: None)


def _torch_run(source: Path, out: Path, **kw):
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info

    be = TorchBackend(device="cpu")
    plan = be.plan(get_video_info(source), rung_pair(BITRATE)[1], out,
                   segment_duration_s=1.0)
    return be.run(plan, **kw)


def _jax_run(source: Path, out: Path, **kw):
    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu.media.probe import get_video_info

    be = JaxBackend()
    plan = be.plan(get_video_info(source), rung_pair(BITRATE)[0], out,
                   segment_duration_s=1.0)
    return be.run(plan, **kw)


def _interrupted(run, source: Path, out: Path, k: int) -> None:
    with pytest.raises(Interrupted):
        run(source, out, resume=False, progress_cb=_stop_after(k))


@pytest.fixture(scope="module")
def torch_whole(source, tmp_path_factory) -> Path:
    out = tmp_path_factory.mktemp("torch_whole")
    res = _torch_run(source, out, resume=False)
    assert res.resumed_segments == 0 and res.frames_processed == N_FRAMES
    return out


@pytest.mark.parametrize("k", [1, 3])
def test_port_resume_equals_uninterrupted_run(source, torch_whole, tmp_path, k):
    out = tmp_path / "out"
    _interrupted(_torch_run, source, out, k)
    assert len(list((out / "96p").glob("segment_*.m4s"))) == k
    res = _torch_run(source, out, resume=True)
    assert res.resumed_segments == 2 * k
    assert res.frames_processed == N_FRAMES
    assert res.thumbnail_path == str(out / "thumbnail.jpg")
    got = _files(out)
    assert got == _files(torch_whole)          # journal bytes included
    assert len(got[JOURNAL].splitlines()) == 1 + 4


@pytest.fixture(scope="module")
def jax_trees(source, tmp_path_factory) -> dict[str, Path]:
    """JaxBackend (one device) uninterrupted, and interrupted after
    dispatch 3."""
    from vlog_tpu.parallel import scheduler

    root = tmp_path_factory.mktemp("jax")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(scheduler, "grid_for_run", lambda *a, **k: None)
        _jax_run(source, root / "whole", resume=False)
        _interrupted(_jax_run, source, root / "cut", 3)
    return {"whole": root / "whole", "cut": root / "cut"}


def test_jax_interrupted_port_resumes(source, jax_trees, tmp_path):
    out = tmp_path / "out"
    shutil.copytree(jax_trees["cut"], out)
    res = _torch_run(source, out, resume=True)
    assert res.resumed_segments == 2 * 3
    assert_same_files(jax_trees["whole"], out)


def test_port_interrupted_jax_resumes(source, jax_trees, jax_single_device,
                                      tmp_path):
    """The port's interrupted tree is the JAX one (journal costs within
    the tolerance), so a JAX successor continues both alike. (JaxBackend
    restarts its chains' ``idr_pic_id`` count at 0 when it resumes, so its
    resumed I+P tree is not its uninterrupted one, ROADMAP Queue C; the
    intra test below compares against the uninterrupted tree.)"""
    out = tmp_path / "out"
    _interrupted(_torch_run, source, out, 3)
    assert_same_files(jax_trees["cut"], out)
    ref = tmp_path / "jax_resumed"
    shutil.copytree(jax_trees["cut"], ref)
    for tree in (ref, out):
        assert _jax_run(source, tree, resume=True).resumed_segments == 2 * 3
    assert_same_files(ref, out)


def test_intra_handoff_both_directions(source, jax_single_device, tmp_path,
                                       monkeypatch):
    """gop_mode=intra, batches of 10 frames (one segment): either backend
    resumes the other's interrupted tree into the uninterrupted JAX
    tree, byte for byte."""
    from vlog_tpu import config as jconfig
    from vlog_tpu_torch import config as tconfig

    for cfg in (jconfig, tconfig):
        monkeypatch.setattr(cfg, "GOP_MODE", "intra")
        monkeypatch.setattr(cfg, "TPU_FRAME_BATCH", 10)
    whole = tmp_path / "whole"
    _jax_run(source, whole, resume=False)
    for first, second in ((_jax_run, _torch_run), (_torch_run, _jax_run)):
        out = tmp_path / f"{first.__name__}_then_{second.__name__}"
        _interrupted(first, source, out, 3)
        res = second(source, out, resume=True)
        assert res.resumed_segments == 2 * 3
        assert _files(out) == _files(whole)


def test_torn_journal_tail_resumes_from_shorter_prefix(source, torch_whole,
                                                       tmp_path):
    """A torn last line drops that batch from the replayable prefix: the
    resume point clamps to the batch before, still byte-identical."""
    out = tmp_path / "out"
    _interrupted(_torch_run, source, out, 3)
    lines = (out / JOURNAL).read_bytes().splitlines(keepends=True)
    assert len(lines) == 1 + 3
    (out / JOURNAL).write_bytes(b"".join(lines[:-1]) + lines[-1][:25])
    res = _torch_run(source, out, resume=True)
    assert res.resumed_segments == 2 * 2
    assert _files(out) == _files(torch_whole)


def test_changed_header_degrades_to_cold_resume(source, tmp_path):
    """A journal from a differently configured run is discarded, as the
    JAX backend discards it: the segments on disk are kept, the
    controllers start cold, the journal stamps the frame the new timeline
    starts from, and the outcome is deterministic."""
    base = tmp_path / "interrupted"
    _interrupted(_torch_run, source, base, 3)
    lines = (base / JOURNAL).read_text().splitlines(keepends=True)
    header = json.loads(lines[0])
    header["tag"] = "h264:cavlc:deblock=1"
    (base / JOURNAL).write_text(json.dumps(header) + "\n" + "".join(lines[1:]))
    kept = {p.name: p.read_bytes() for p in (base / "96p").glob("*.m4s")}
    for name in ("a", "b"):
        shutil.copytree(base, tmp_path / name)
        res = _torch_run(source, tmp_path / name, resume=True)
        assert res.resumed_segments == 2 * 3
    got = _files(tmp_path / "a")
    assert got == _files(tmp_path / "b")
    head, *entries = got[JOURNAL].splitlines()
    assert json.loads(head)["origin_frame"] == 30
    assert [json.loads(e)["k"] for e in entries] == [0]
    for seg, data in kept.items():
        assert got[f"96p/{seg}"] == data


def test_mismatched_init_restarts_the_rung(source, tmp_path, monkeypatch):
    """Segments written under another encoder configuration (here the
    entropy coder) are not appended to: the run restarts from segment 0."""
    from vlog_tpu_torch import config

    out = tmp_path / "out"
    _torch_run(source, out, resume=False)
    seg = out / "96p" / "segment_00001.m4s"
    first = seg.read_bytes()
    assert _torch_run(source, out, resume=True).resumed_segments == 2 * 4
    monkeypatch.setattr(config, "H264_ENTROPY", "cavlc")
    res = _torch_run(source, out, resume=True)
    assert res.resumed_segments == 0
    assert seg.read_bytes() != first
    assert (out / "96p" / "encoder.tag").read_text().startswith("h264:cavlc")
