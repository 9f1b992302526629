"""The port's MP4 demux, progressive MP4 writer and probe against the JAX
package's (``vlog_tpu/media/{mp4,fmp4,probe}.py``).

Inputs are seeded numpy bytes (opaque sample payloads, a fake avcC) in
single- and multi-track progressive MP4s, with and without ``stss``, and
with ``co64`` chunk offsets. Tolerance: none: written bytes, parsed
fields, sample bytes and probe results are equal, and both packages
raise the same exception class with the same message.

Also the shared fixtures of the port's decoder, source and sprite tests:
``ip_mp4`` remuxes the 1080p-style I+P CABAC output of ``JaxBackend``
(deblocked, rate-controlled) into a progressive MP4, the platform's own
upload shape.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np
import pytest

from vlog_tpu.media import fmp4 as jfmp4
from vlog_tpu.media import mp4 as jmp4
from vlog_tpu.media import probe as jprobe
from vlog_tpu_torch.media import fmp4 as tfmp4
from vlog_tpu_torch.media import mp4 as tmp4
from vlog_tpu_torch.media import probe as tprobe

from tests.fixtures.media import make_y4m


# ---------------------------------------------------------------------------
# Shared fixtures
# ---------------------------------------------------------------------------

def cmaf_samples(rung_dir: Path):
    """(avc1 sample entry, width, height, [(data, duration, is_sync)]) of
    a CMAF rung directory: init.mp4's stsd entry and every segment's
    trun/mdat, read with the port's box parser."""
    from vlog_tpu_torch.media.boxes import parse_box_tree

    with open(rung_dir / "init.mp4", "rb") as fp:
        moov = next(b for b in parse_box_tree(fp) if b.type == "moov")
    entry = moov.find("trak", "mdia", "minf", "stbl", "stsd").payload[8:]
    width, height = struct.unpack(">HH", entry[32:36])
    samples = []
    for seg in sorted(rung_dir.glob("segment_*.m4s")):
        data = seg.read_bytes()
        with open(seg, "rb") as fp:
            moof = next(b for b in parse_box_tree(fp) if b.type == "moof")
        trun = moof.find("traf", "trun").payload
        count, off = struct.unpack(">Ii", trun[4:12])
        pos = moof.offset + off            # default-base-is-moof
        for k in range(count):
            dur, size, flags = struct.unpack(">III", trun[12 + 16 * k:24 + 16 * k])
            samples.append((data[pos:pos + size], dur, not flags & 0x00010000))
            pos += size
    return entry, width, height, samples


def write_progressive(path: Path, entry: bytes, width: int, height: int,
                      samples, timescale: int) -> Path:
    """One-track progressive MP4 through the port's writer."""
    track = tfmp4.TrackConfig(1, "vide", timescale, entry, width, height)
    path.write_bytes(tfmp4.progressive_mp4(
        track, [tfmp4.Sample(d, dur, is_sync=s) for d, dur, s in samples]))
    return path


def jax_ip_tree(tmp_path: Path, n_frames: int = 20, fps: int = 10,
                bitrate: int = 300_000) -> Path:
    """JaxBackend's 96x128 I+P CABAC rung (deblock on, rate control on,
    1 s segments: 10-frame chains), its CMAF rung directory."""
    from vlog_tpu import config as jconfig
    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu.parallel import scheduler

    src = make_y4m(tmp_path / "ip_src.y4m", n_frames=n_frames, width=128,
                   height=96, fps=fps)
    rung = jconfig.QualityRung("96p", 96, bitrate, 0, base_qp=30)
    saved = scheduler.grid_for_run
    scheduler.grid_for_run = lambda *a, **k: None
    try:
        jb = JaxBackend()
        plan = jb.plan(jprobe.get_video_info(src), (rung,),
                       tmp_path / "ip_tree", segment_duration_s=1.0,
                       thumbnail=False)
        jb.run(plan, resume=False)
    finally:
        scheduler.grid_for_run = saved
    return tmp_path / "ip_tree" / "96p"


def ip_mp4(tmp_path: Path, n_frames: int = 20, fps: int = 10) -> Path:
    """A progressive MP4 of JaxBackend's I+P CABAC output (stss lists
    the IDRs, one per 10 frames)."""
    entry, w, h, samples = cmaf_samples(jax_ip_tree(tmp_path, n_frames, fps))
    return write_progressive(tmp_path / "ip.mp4", entry, w, h, samples,
                             fps * 1000)


def intra_mp4(tmp_path: Path, n_frames: int = 6, width: int = 128,
              height: int = 96, fps: int = 10, qp: int = 26) -> Path:
    """An all-intra CAVLC MP4 from the JAX encoder (no stss: every sample
    is a sync sample)."""
    from tests.fixtures.media import synthetic_yuv_frames
    from vlog_tpu.codecs.h264.api import H264Encoder

    frames = synthetic_yuv_frames(n_frames, width, height, seed=5)
    ys, us, vs = (np.stack([f[i] for f in frames]) for i in range(3))
    enc = H264Encoder(width=width, height=height, qp=qp, fps_num=fps)
    encoded = enc.encode(ys, us, vs)
    entry = jfmp4.avc1_sample_entry(width, height, enc.avcc_config)
    return write_progressive(tmp_path / "intra.mp4", entry, width, height,
                             [(f.avcc, 1000, True) for f in encoded],
                             fps * 1000)


# ---------------------------------------------------------------------------
# Demux and writer parity
# ---------------------------------------------------------------------------

def _tracks(rng, *, multi: bool, stss: bool):
    """[(handler, timescale, sample entry, w, h, samples)] with seeded
    payloads; ``stss`` False makes every sample a sync sample."""
    sps = bytes([0x67, 0x4D, 0x40, 0x1E]) + rng.bytes(6)
    pps = bytes([0x68, 0xEE, 0x3C, 0x80])
    entry = jfmp4.avc1_sample_entry(96, 64, jfmp4.avcc_config(sps, pps))
    vs = [(rng.bytes(int(rng.integers(5, 200))), 1000,
           (not stss) or i % 4 == 0) for i in range(13)]
    tracks = [("vide", 10_000, entry, 96, 64, vs)]
    if multi:
        aentry = jfmp4.mp4a_sample_entry(2, 48_000, bytes([0x11, 0x90]))
        aus = [(rng.bytes(int(rng.integers(50, 300))), 1024, True)
               for _ in range(20)]
        tracks.append(("soun", 48_000, aentry, 0, 0, aus))
    return tracks


def _write_both(tracks) -> tuple[bytes, bytes]:
    def build(mod):
        return mod.progressive_mp4_multi([
            (mod.TrackConfig(i + 1, hd, ts, entry, w, h),
             [mod.Sample(d, dur, is_sync=s) for d, dur, s in ss])
            for i, (hd, ts, entry, w, h, ss) in enumerate(tracks)])
    return build(jfmp4), build(tfmp4)


def _with_co64(data: bytes) -> bytes:
    """The same one-chunk-per-track file with every stco box rewritten as
    co64 (8-byte offsets): parent box sizes grow by 4 per track and the
    chunk offsets move by the moov's growth."""
    from vlog_tpu_torch.media.boxes import parse_box_tree
    import io

    tree = parse_box_tree(io.BytesIO(data))
    moov = next(b for b in tree if b.type == "moov")
    traks = moov.find_all("trak")
    grow = 4 * len(traks)
    out = bytearray(data)
    edits = []                        # (offset, old size box, co64 bytes)
    for trak in traks:
        stbl = trak.find("mdia", "minf", "stbl")
        stco = next(c for c in stbl.children if c.type == "stco")
        (off,) = struct.unpack(">I", stco.payload[8:12])
        co64 = struct.pack(">I4sIIQ", 24, b"co64", 0, 1, off + grow)
        edits.append((stco.offset, stco.size, co64))
        for parent in (trak, trak.find("mdia"), trak.find("mdia", "minf"), stbl):
            struct.pack_into(">I", out, parent.offset, parent.size + 4)
    struct.pack_into(">I", out, moov.offset, moov.size + grow)
    for off, size, co64 in sorted(edits, reverse=True):
        out[off:off + size] = co64
    return bytes(out)


def _assert_movies_equal(jm, tm):
    assert (tm.path, tm.movie_timescale, tm.duration_s) == \
        (jm.path, jm.movie_timescale, jm.duration_s)
    assert len(tm.tracks) == len(jm.tracks)
    for jt, tt in zip(jm.tracks, tm.tracks):
        for f in dataclasses.fields(jt):
            if f.name == "samples":
                continue
            assert getattr(tt, f.name) == getattr(jt, f.name), f.name
        assert tt.fps == jt.fps and tt.duration_s == jt.duration_s
        assert tt.codec_string() == jt.codec_string()
        for f in dataclasses.fields(jt.samples):
            a, b = getattr(jt.samples, f.name), getattr(tt.samples, f.name)
            if a is None:
                assert b is None, f.name
            else:
                assert b.dtype == a.dtype and np.array_equal(a, b), f.name
        assert [tt.samples.is_sync(i) for i in range(tt.samples.count)] == \
            [jt.samples.is_sync(i) for i in range(jt.samples.count)]


@pytest.mark.parametrize("co64", [False, True], ids=["stco", "co64"])
@pytest.mark.parametrize("stss", [True, False], ids=["stss", "no_stss"])
@pytest.mark.parametrize("multi", [False, True], ids=["video", "av"])
def test_progressive_mp4_parse_and_samples_match_jax(tmp_path, multi, stss,
                                                     co64):
    rng = np.random.default_rng(17 + 2 * multi + stss)
    tracks = _tracks(rng, multi=multi, stss=stss)
    jdata, tdata = _write_both(tracks)
    assert tdata == jdata
    path = tmp_path / "m.mp4"
    path.write_bytes(_with_co64(tdata) if co64 else tdata)
    jm, tm = jmp4.parse_mp4(path), tmp4.parse_mp4(path)
    _assert_movies_equal(jm, tm)
    assert (tm.video.samples.sync_indices is None) == (not stss)
    for k, (jt, tt) in enumerate(zip(jm.tracks, tm.tracks)):
        with jmp4.SampleReader(path, jt) as jr, tmp4.SampleReader(path, tt) as tr:
            got = tr.read_range(0, tt.samples.count + 3)
            assert got == jr.read_range(0, jt.samples.count + 3)
            assert got == [d for d, _, _ in tracks[k][5]]
            with pytest.raises(IndexError):
                tr.read_sample(tt.samples.count)


def test_get_video_info_and_sniff_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    y4m_path = make_y4m(tmp_path / "s.y4m", n_frames=5, width=64, height=48)
    paths = [y4m_path]
    for multi in (False, True):
        p = tmp_path / f"m{int(multi)}.mp4"
        p.write_bytes(_write_both(_tracks(rng, multi=multi, stss=True))[1])
        paths.append(p)
    for p in paths:
        assert tprobe.sniff_container(p) == jprobe.sniff_container(p)
        assert dataclasses.asdict(tprobe.get_video_info(p)) == \
            dataclasses.asdict(jprobe.get_video_info(p))


def _raises_alike(fn_j, fn_t):
    with pytest.raises(Exception) as ej:
        fn_j()
    with pytest.raises(Exception) as et:
        fn_t()
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)
    return et.value


@pytest.mark.parametrize("case", ["missing", "empty", "no_moov", "garbage"])
def test_probe_and_demux_errors_match_jax(tmp_path, case):
    path = tmp_path / f"{case}.bin"
    if case == "empty":
        path.write_bytes(b"")
    elif case == "no_moov":
        # an ftyp and nothing else: sniffs as MP4, has no moov
        path.write_bytes(struct.pack(">I4s4sI8s", 24, b"ftyp", b"isom", 512,
                                     b"isomiso2"))
    elif case == "garbage":
        path.write_bytes(np.random.default_rng(1).bytes(64))
    err = _raises_alike(lambda: jprobe.get_video_info(path),
                        lambda: tprobe.get_video_info(path))
    assert isinstance(err, tprobe.ProbeError)
    if case in ("missing", "empty", "garbage"):
        return
    e = _raises_alike(lambda: jmp4.parse_mp4(path), lambda: tmp4.parse_mp4(path))
    assert isinstance(e, tmp4.Mp4Error)


def test_sniff_unknown_raises_probe_error(tmp_path):
    path = tmp_path / "x.bin"
    path.write_bytes(b"RIFF\x00\x00\x00\x00WAVEfmt ")
    err = _raises_alike(lambda: jprobe.sniff_container(path),
                        lambda: tprobe.sniff_container(path))
    assert isinstance(err, tprobe.ProbeError)
