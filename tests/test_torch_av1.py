"""The port's AV1 re-encode (``vlog_tpu_torch/backends/av1_path.py``)
against the JAX package's, on the CPU.

The encode is delegated to the system AV1 encoder through the port's copy
of the libav shim (``native/av1enc.c``); the device step is the per-rung
resize (the port's plain version on the CPU). Source: a seeded 96x128
Y4M, 24 frames at 12 fps, 1 s segments, the rungs of
``tests/test_torch_backend.py::rung_pair`` (96p identity, 64p scaled) at
250 kbps. The ``source`` fixture first holds the 64p planes of the JAX
path's resize (``vlog_tpu.ops.resize.resize_yuv420``) equal to the
port's (ROADMAP Queue C item 1 picks the seed).

- The sequence-header parse and the ``av01`` codec string equal JAX's on
  the same temporal units, and on every (profile, level, tier) the init
  box parser (``media/codecstr.py``) renders the same string.
- ``TorchBackend.run(codec="av1")`` writes ``JaxBackend``'s tree, byte
  for byte: the encoder gets equal planes, and two runs of it on equal
  planes gave equal bytes.
- Under a 2-wide lease the 2x1 grid (frames sharded over the data axis,
  the batch padded) and the 1x2 grid (one rung per column) write the
  one-device tree.
- ``process_video(codec="av1")`` verifies its tree, and the stream
  decodes through the port's shim to the source's frame count and size.
- ``hls_ts`` raises ``ValueError`` and a missing shim ``Av1Unavailable``,
  with the reference's messages.

Skips only where the shim or an AV1 encoder is missing, as
``tests/test_av1.py`` does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from tests.fixtures.media import make_y4m, synthetic_yuv_frames
from tests.test_torch_backend import _files, one_torch_thread, rung_pair  # noqa: F401
from tests.test_torch_grid_backend import mesh_spec, torch_run  # noqa: F401

SEED, N_FRAMES, FPS, BITRATE = 4, 24, 12, 250_000
OPTS = dict(segment_duration_s=1.0, codec="av1")


def _need_av1():
    from vlog_tpu_torch.native.build import get_av_lib

    lib = get_av_lib()
    if lib is None:
        pytest.skip("libav shim unavailable")
    h = lib.vt_av1_open(64, 64, 24, 1, 200_000, 8, 8)
    if not h:
        pytest.skip("no system AV1 encoder")
    lib.vt_av1_close(h)
    return lib


@pytest.fixture(scope="module")
def source(tmp_path_factory) -> Path:
    """The Y4M, after checking that both packages resize its 64p rung
    alike."""
    _need_av1()
    import jax.numpy as jnp
    import torch

    from vlog_tpu.ops.resize import resize_yuv420 as jax_resize
    from vlog_tpu.parallel.ladder import ladder_matrices
    from vlog_tpu_torch.ops.fused_resize import resize_yuv420
    from vlog_tpu_torch.parallel.ladder import mats_from_numpy

    frames = synthetic_yuv_frames(N_FRAMES, 128, 96, seed=SEED)
    planes = [np.stack([f[k] for f in frames]) for k in range(3)]
    want = jax_resize(*(jnp.asarray(p) for p in planes), 64, 86)
    jm = ladder_matrices((("64p", 64, 86, 0),), 96, 128)["64p"]
    got = resize_yuv420(*(torch.from_numpy(p) for p in planes),
                        mats_from_numpy({"64p": jm}, "cpu")["64p"])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return make_y4m(tmp_path_factory.mktemp("av1_src") / "src.y4m",
                    n_frames=N_FRAMES, width=128, height=96, fps=FPS,
                    seed=SEED)


@pytest.fixture(scope="module")
def port_tree(source, tmp_path_factory):
    """The port's one-device tree and run result."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = tmp_path_factory.mktemp("av1_port") / "out"
        res, _ = torch_run(source, out, rung_pair(BITRATE)[1], **OPTS)
    finally:
        torch.set_num_threads(n)
    return out, res


def _key_tus(lib, w: int, h: int, n: int, seed: int) -> list[bytes]:
    """``n`` temporal units of the port's shim encoder, each a forced
    keyframe of seeded noise planes."""
    from vlog_tpu_torch.backends.av1_path import _ShimEncoder

    rng = np.random.default_rng(seed)
    enc = _ShimEncoder(lib, w, h, 24, 1, 300_000, 8)
    tus = []
    try:
        for _ in range(n):
            y = rng.integers(0, 256, (h, w), np.uint8)
            u = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
            v = rng.integers(0, 256, (h // 2, w // 2), np.uint8)
            enc.send(y, u, v, force_key=True)
            tus.extend(d for d, _, _ in enc.receive())
        tus.extend(d for d, _, _ in enc.flush())
    finally:
        enc.close()
    assert len(tus) == n
    return tus


@pytest.mark.parametrize("w,h", [(128, 96), (86, 64), (352, 288)])
def test_seq_header_and_codec_string_equal_jax(w, h):
    from vlog_tpu.codecs import av1 as jav1
    from vlog_tpu_torch.codecs import av1 as tav1

    lib = _need_av1()
    for tu in _key_tus(lib, w, h, 2, seed=w):
        assert list(tav1.iter_obus(tu)) == list(jav1.iter_obus(tu))
        fields = tav1.parse_seq_header(tu)
        assert fields == jav1.parse_seq_header(tu)
        meta = dict(zip(("profile", "level", "tier"), fields))
        assert tav1.codec_string_from_tu(meta) == \
            jav1.codec_string_from_tu(meta)
    assert tav1.codec_string_from_tu(None) == jav1.codec_string_from_tu(None)


@pytest.mark.parametrize("prof,level,tier", [
    (0, 8, 0), (0, 13, 0), (1, 13, 1), (2, 19, 1), (0, 5, 0),
])
def test_av1c_record_and_codec_strings_equal_jax(prof, level, tier):
    """The av1C record, its av01 sample entry, and both codec-string
    parsers (sequence-header fields, init box) of each package."""
    from vlog_tpu.codecs.av1 import codec_string_from_tu as jstr
    from vlog_tpu.media import fmp4 as jfmp4
    from vlog_tpu.media.codecstr import codec_string_from_init as jinit
    from vlog_tpu_torch.codecs.av1 import codec_string_from_tu as tstr
    from vlog_tpu_torch.media import fmp4 as tfmp4
    from vlog_tpu_torch.media.codecstr import codec_string_from_init as tinit

    rec = tfmp4.av1c_record(prof, level, tier)
    assert rec == jfmp4.av1c_record(prof, level, tier)
    assert tfmp4.av01_sample_entry(86, 64, rec) == \
        jfmp4.av01_sample_entry(86, 64, rec)
    meta = {"profile": prof, "level": level, "tier": tier}
    blob = b"xxxx" + b"av1C" + rec
    assert tstr(meta) == jstr(meta) == tinit(blob) == jinit(blob)


def test_plan_accepts_av1_like_jax(source, tmp_path):
    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu.media.probe import get_video_info as jprobe
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info as tprobe

    jr, tr = rung_pair(BITRATE)
    tplan = TorchBackend(device="cpu").plan(tprobe(source), tr, tmp_path,
                                            **OPTS)
    jplan = JaxBackend().plan(jprobe(source), jr, tmp_path, **OPTS)
    assert [(r.name, r.width, r.height, r.codec, r.video_bitrate)
            for r in tplan.rungs] == \
        [(r.name, r.width, r.height, r.codec, r.video_bitrate)
         for r in jplan.rungs]
    assert {r.codec for r in tplan.rungs} == {"av1"}


def test_tree_equals_jax(source, port_tree, tmp_path):
    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu.media.probe import get_video_info
    from vlog_tpu.parallel import scheduler

    out, res = port_tree
    be = JaxBackend()
    plan = be.plan(get_video_info(source), rung_pair(BITRATE)[0],
                   tmp_path / "jax", **OPTS)
    prev = scheduler.grid_for_run
    scheduler.grid_for_run = lambda *a, **k: None     # one device
    try:
        jres = be.run(plan, resume=False)
    finally:
        scheduler.grid_for_run = prev
    want = _files(tmp_path / "jax")
    got = _files(out)
    assert sorted(got) == sorted(want)
    assert sum(k.endswith(".m4s") for k in got) == 4
    for k in want:
        assert got[k] == want[k], k
    assert [(r.name, r.codec_string, r.segment_count, r.bytes_written)
            for r in res.rungs] == \
        [(r.name, r.codec_string, r.segment_count, r.bytes_written)
         for r in jres.rungs]
    assert res.frames_processed == jres.frames_processed == N_FRAMES
    assert all(r.codec_string.startswith("av01.0.") for r in res.rungs)


@pytest.mark.parametrize("spec,label,batch", [
    ("data:2,rung:1", "2x1", 5),       # 5-frame batches padded to 6
    ("data:1,rung:2", "1x2", None),    # one rung per column
])
def test_grid_run_equals_one_device(source, port_tree, tmp_path, mesh_spec,
                                    spec, label, batch):
    out, _ = port_tree
    opts = dict(OPTS)
    want = _files(out)
    if batch is not None:
        opts["frame_batch"] = batch
    mesh_spec(spec)
    res, shape = torch_run(source, tmp_path / label, rung_pair(BITRATE)[1],
                           ["cpu"] * 2, **opts)
    assert shape == label and res.frames_processed == N_FRAMES
    if batch is not None:
        assert res.stage_s["pad_frames"] > 0
    assert _files(tmp_path / label) == want


def test_process_video_av1_verifies_and_decodes(source, tmp_path):
    from vlog_tpu_torch import config
    from vlog_tpu_torch.backends.source import open_source
    from vlog_tpu_torch.worker.pipeline import process_video

    rung = config.QualityRung("96p", 96, BITRATE, 0, base_qp=30)
    res = process_video(source, tmp_path / "out", codec="av1", audio=False,
                        resume=False, rungs=(rung,), segment_duration_s=1.0,
                        device="cpu")
    r = res.run.rungs[0]
    assert r.codec_string.startswith("av01.0.") and r.segment_count == 2
    master = (tmp_path / "out" / "master.m3u8").read_text()
    assert "av01" in master and "avc1" not in master
    rdir = tmp_path / "out" / r.name
    init = (rdir / "init.mp4").read_bytes()
    assert b"av01" in init and b"av1C" in init
    stream = tmp_path / "round.mp4"
    stream.write_bytes(init + b"".join(
        p.read_bytes() for p in sorted(rdir.glob("segment_*.m4s"))))
    s = open_source(stream, "cpu")
    try:
        frames = [f for y, _, _ in s.read_batches(8) for f in y]
    finally:
        s.close()
    assert len(frames) == N_FRAMES and frames[0].shape == (96, 128)
    # the decoded frames follow the source (a lossy code at 250 kbps)
    src = synthetic_yuv_frames(N_FRAMES, 128, 96, seed=SEED)
    err = np.mean([np.abs(np.asarray(f, np.float64) - s_[0]).mean()
                   for f, s_ in zip(frames, src)])
    assert err < 20.0, err


def test_segments_start_on_keyframes(port_tree):
    """Every segment's first sample is a sync sample (the forced
    keyframes), and each segment holds one second of frames."""
    import io

    from vlog_tpu_torch.media.boxes import parse_box_tree

    out, _ = port_tree
    for rdir in sorted(p for p in out.iterdir() if p.is_dir()):
        for seg in sorted(rdir.glob("segment_*.m4s")):
            boxes = parse_box_tree(io.BytesIO(seg.read_bytes()))
            trun = next(b for b in _walk(boxes) if b.type == "trun")
            n = int.from_bytes(trun.payload[4:8], "big")
            first_flags = int.from_bytes(trun.payload[12 + 8:12 + 12], "big")
            assert n == FPS
            assert not first_flags & 0x10000, seg   # sample_is_non_sync off


def _walk(boxes):
    for b in boxes:
        yield b
        yield from _walk(b.children or ())


def test_hls_ts_and_missing_shim_raise_like_jax(source, tmp_path,
                                               monkeypatch):
    from vlog_tpu.backends import av1_path as jpath
    from vlog_tpu.native import avbuild
    from vlog_tpu_torch.backends import av1_path as tpath
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info

    be = TorchBackend(device="cpu")
    tr = rung_pair(BITRATE)[1]
    plan = be.plan(get_video_info(source), tr, tmp_path / "ts",
                   codec="av1", streaming_format="hls_ts")
    with pytest.raises(ValueError) as got:
        be.run(plan, resume=False)
    with pytest.raises(ValueError) as want:
        jpath.run_av1(None, plan, None, False, 0.0)
    assert str(got.value) == str(want.value)
    monkeypatch.setattr(tpath, "get_av_lib", lambda: None)
    monkeypatch.setattr(avbuild, "get_av_lib", lambda: None)
    plan = be.plan(get_video_info(source), tr, tmp_path / "none", **OPTS)
    with pytest.raises(tpath.Av1Unavailable) as got:
        be.run(plan, resume=False)
    with pytest.raises(jpath.Av1Unavailable) as want:
        jpath.run_av1(None, plan, None, False, 0.0)
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "none").exists()


def test_shim_encoder_output_is_deterministic(source):
    """Two encoders fed the same planes emit the same temporal units
    (what the byte-equal trees rest on)."""
    lib = _need_av1()
    runs = [_key_tus(lib, 128, 96, 3, seed=7) for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(isinstance(t, bytes) and t for t in runs[0])
