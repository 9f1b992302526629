"""The port's frame sources (``vlog_tpu_torch/backends/source.py``) and
``TorchBackend`` on an MP4 source, against the JAX package's.

Sources: JaxBackend's 96x128 I+P CABAC output (deblocked, rate
controlled, an IDR every 10 frames) remuxed into a progressive MP4, an
all-intra CAVLC MP4, a tiny Y4M and, where the libav shim builds, a raw
Annex-B file only libav opens. Tolerance: decoded planes are bit-exact;
where the JAX source's answer is right (sequential reads, starts at an
IDR) the port's equals it, and a read that starts mid-GOP (fresh, or
after earlier reads) equals the sequential decode's frame, where the JAX
source raises or returns another frame (ROADMAP Queue C item 7). The
backend's CMAF trees are byte-identical to JaxBackend's except the
journal's ``cost`` (relative 1e-5, as in tests/test_torch_backend.py).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from vlog_tpu.backends import source as jsrc
from vlog_tpu_torch.backends import source as tsrc
from vlog_tpu_torch.native import get_av_lib

from tests.fixtures.media import make_y4m
from tests.test_torch_backend import (assert_same_files,  # noqa: F401
                                      one_torch_thread, rung_pair)
from tests.test_torch_mp4 import intra_mp4, ip_mp4


@pytest.fixture(scope="module")
def ip_path(tmp_path_factory) -> Path:
    return ip_mp4(tmp_path_factory.mktemp("ip"), n_frames=25)


@pytest.fixture(scope="module")
def sequential(ip_path):
    """The port's sequential decode of every frame (asserted equal to the
    JAX source's in the first test)."""
    with tsrc.Mp4H264FrameSource(ip_path, "cpu") as src:
        return next(src.read_batches(25, 0))


def _same(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.uint8
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("batch", [1, 4, 10, 25])
def test_sequential_reads_match_jax(ip_path, sequential, batch):
    with jsrc.Mp4H264FrameSource(ip_path) as js, \
            tsrc.Mp4H264FrameSource(ip_path, "cpu") as ts:
        assert (ts.frame_count, ts.fps_num, ts.fps_den) == \
            (js.frame_count, js.fps_num, js.fps_den)
        got = list(ts.read_batches(batch))
        want = list(js.read_batches(batch))
        assert [g[0].shape for g in got] == [w[0].shape for w in want]
        for g, w in zip(got, want):
            _same(g, w)
        assert ts.frames_decoded == 25
    _same([np.concatenate([g[i] for g in got]) for i in range(3)], sequential)


def test_read_at_an_idr_matches_jax(ip_path):
    with jsrc.Mp4H264FrameSource(ip_path) as js, \
            tsrc.Mp4H264FrameSource(ip_path, "cpu") as ts:
        _same(next(ts.read_batches(7, 10)), next(js.read_batches(7, 10)))
        assert ts.frames_decoded == 7            # no frame before the IDR


@pytest.mark.parametrize("k", [5, 9, 13, 24])
def test_mid_gop_read_on_a_fresh_source(ip_path, sequential, k):
    from vlog_tpu_torch.media import mp4

    assert k not in mp4.parse_mp4(ip_path).video.samples.sync_indices
    with tsrc.Mp4H264FrameSource(ip_path, "cpu") as ts:
        got = next(ts.read_batches(2, k))
        _same(got, [p[k:k + 2] for p in sequential])
        assert ts.frames_decoded == k % 10 + len(got[0])   # from its IDR


def test_reads_after_earlier_reads_continue_or_restart(ip_path, sequential):
    """Forward inside a GOP continues from the decoder's position; a read
    into a later GOP starts at its IDR; a read backwards restarts."""
    steps = [  # (start, count, frames decoded by this read)
        (0, 1, 1), (4, 1, 4), (6, 2, 3), (17, 1, 8), (3, 2, 5), (5, 1, 1),
        (24, 1, 5)]
    with tsrc.Mp4H264FrameSource(ip_path, "cpu") as ts:
        for start, count, cost in steps:
            before = ts.frames_decoded
            got = next(ts.read_batches(count, start))
            _same(got, [p[start:start + count] for p in sequential])
            assert ts.frames_decoded - before == cost, (start, count)


def test_all_intra_mp4_matches_jax(tmp_path):
    path = intra_mp4(tmp_path)
    with jsrc.Mp4H264FrameSource(path) as js, \
            tsrc.Mp4H264FrameSource(path, "cpu") as ts:
        _same(next(ts.read_batches(6)), next(js.read_batches(6)))
        for k in (4, 1, 5):                      # every sample an IDR
            before = ts.frames_decoded
            _same(next(ts.read_batches(1, k)), next(js.read_batches(1, k)))
            assert ts.frames_decoded - before == 1


def test_open_source_dispatch(tmp_path, ip_path):
    y4m = make_y4m(tmp_path / "s.y4m", n_frames=3, width=64, height=48)
    with tsrc.open_source(y4m, "cpu") as src:
        assert isinstance(src, tsrc.Y4mFrameSource) and src.exact_seek
        with jsrc.open_source(y4m) as js:
            _same(next(src.read_batches(3)), next(js.read_batches(3)))
    with tsrc.open_source(ip_path, "cpu") as src:
        assert isinstance(src, tsrc.Mp4H264FrameSource) and src.exact_seek


def _annexb_file(tmp_path: Path) -> Path:
    """A raw H.264 elementary stream: no container magic, so only the
    libav shim opens it."""
    from tests.fixtures.media import synthetic_yuv_frames
    from vlog_tpu.codecs.h264.api import H264Encoder

    frames = synthetic_yuv_frames(5, 64, 48, seed=2)
    ys, us, vs = (np.stack([f[i] for f in frames]) for i in range(3))
    enc = H264Encoder(width=64, height=48, qp=24, fps_num=10)
    path = tmp_path / "raw.h264"
    path.write_bytes(b"".join(f.annexb for f in enc.encode(ys, us, vs)))
    return path


@pytest.mark.skipif(get_av_lib() is None, reason="libav shim unavailable")
def test_libav_source_matches_jax(tmp_path):
    path = _annexb_file(tmp_path)
    with tsrc.open_source(path, "cpu") as ts, jsrc.open_source(path) as js:
        assert isinstance(ts, tsrc.LibavFrameSource)
        assert not ts.exact_seek
        assert (ts.frame_count, ts.fps_num, ts.fps_den) == \
            (js.frame_count, js.fps_num, js.fps_den)
        assert vars(ts.info) == vars(js.info)
        got, want = list(ts.read_batches(2)), list(js.read_batches(2))
        assert len(got) == len(want) and len(got) >= 2
        for g, w in zip(got, want):
            _same(g, w)


def test_unopenable_source_raises_like_jax(tmp_path):
    path = tmp_path / "junk.bin"
    path.write_bytes(np.random.default_rng(4).bytes(256))
    with pytest.raises(jsrc.UnsupportedSource) as ej:
        jsrc.open_source(path)
    with pytest.raises(tsrc.UnsupportedSource) as et:
        tsrc.open_source(path, "cpu")
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# TorchBackend on the MP4 source
# ---------------------------------------------------------------------------

BITRATE = 150_000


class Interrupted(RuntimeError):
    pass


def _run(pkg: str, source: Path, out: Path, **kw):
    """One run of either backend on ``source`` (96p identity rung + 64p,
    1 s segments, rate control on); JaxBackend pinned to one device."""
    if pkg == "jax":
        from vlog_tpu.backends.jax_backend import JaxBackend as Backend
        from vlog_tpu.media.probe import get_video_info
        from vlog_tpu.parallel import scheduler

        scheduler_saved = scheduler.grid_for_run
        scheduler.grid_for_run = lambda *a, **k: None
        be, rungs = Backend(), rung_pair(BITRATE)[0]
    else:
        from vlog_tpu_torch.backends.torch_backend import TorchBackend
        from vlog_tpu_torch.media.probe import get_video_info

        be, rungs = TorchBackend(device="cpu"), rung_pair(BITRATE)[1]
    try:
        plan = be.plan(get_video_info(source), rungs, out,
                       segment_duration_s=1.0)
        return be.run(plan, **kw)
    finally:
        if pkg == "jax":
            scheduler.grid_for_run = scheduler_saved


def test_backend_on_mp4_matches_jax_fresh_and_resumed(tmp_path, ip_path):
    """25 frames (the last dispatch holds 5), thumbnail on; the port's
    run stopped after dispatch 2 and resumed at segment 3 (an IDR of the
    source and of the output) writes JaxBackend's uninterrupted tree."""
    jres = _run("jax", ip_path, tmp_path / "jax", resume=False)
    tres = _run("torch", ip_path, tmp_path / "torch", resume=False)
    assert tres.frames_processed == jres.frames_processed == 25
    assert tres.stage_s["decode_wait_s"] > 0
    assert_same_files(tmp_path / "jax", tmp_path / "torch")

    def stop_after_two(done, total, msg):
        if done >= 20:
            raise Interrupted(msg)

    cut = tmp_path / "cut"
    with pytest.raises(Interrupted):
        _run("torch", ip_path, cut, progress_cb=stop_after_two, resume=False)
    res = _run("torch", ip_path, cut, resume=True)
    assert res.resumed_segments == 2 * 2              # 2 segments x 2 rungs
    assert_same_files(tmp_path / "jax", cut)
