"""MPEG-TS output of the port (``streaming_format="hls_ts"``) against the
JAX package: the muxer on the same samples, and whole trees from
TorchBackend(device="cpu") and JaxBackend on the tiny Y4M (setup of
tests/test_torch_backend.py, 20 frames, two 1 s segments per rung),
video-only and with the same ADTS frames handed to both plans. Tolerance:
byte identity. Where tests/test_ts.py's libav ``tsdec`` oracle builds, the
port's segments also demux and decode to every frame.
"""

from __future__ import annotations

import subprocess

import numpy as np

from tests.test_torch_backend import (_files, assert_same_files,  # noqa: F401
                                      one_torch_thread, run_both)
from tests.test_ts import tsdec  # noqa: F401  (the libav oracle fixture)

SR = 48_000


def _adts_frames(n: int, seed: int = 0) -> list[bytes]:
    """Opaque ADTS-framed payloads (the muxer does not parse them)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        body = rng.integers(0, 256, int(rng.integers(40, 300)), dtype=np.uint8)
        size = 7 + body.size
        hdr = bytes([0xFF, 0xF1, 0x4C, 0x80 | (size >> 11),
                     (size >> 3) & 0xFF, ((size & 7) << 5) | 0x1F, 0xFC])
        out.append(hdr + body.tobytes())
    return out


def _rungs(audio_rate: int):
    from vlog_tpu import config as jconfig
    from vlog_tpu_torch import config as tconfig

    spec = (("96p", 96, 0, audio_rate, 30), ("64p", 64, 0, 64_000, 31))
    return tuple(tuple(cfg.QualityRung(n, h, b, a, base_qp=q)
                       for n, h, b, a, q in spec)
                 for cfg in (jconfig, tconfig))


def _check_ts_tree(root) -> dict[str, bytes]:
    files = _files(root)
    assert not any(k.endswith(("init.mp4", ".m4s", "manifest.mpd",
                               "rc_journal.jsonl")) for k in files)
    segs = sorted(k for k in files if k.endswith(".ts"))
    assert segs == ["64p/segment_00001.ts", "64p/segment_00002.ts",
                    "96p/segment_00001.ts", "96p/segment_00002.ts"]
    for k in segs:
        data = files[k]
        assert len(data) % 188 == 0
        assert all(data[i] == 0x47 for i in range(0, len(data), 188))
    assert "EXT-X-MAP" not in files["96p/playlist.m3u8"].decode()
    return files


def test_ts_muxer_matches_jax():
    from vlog_tpu.media import ts as jts
    from vlog_tpu_torch.media import ts as tts

    rng = np.random.default_rng(4)
    frames = [bytes(rng.integers(0, 256, int(rng.integers(10, 900)),
                                 dtype=np.uint8)) for _ in range(12)]
    adts = _adts_frames(20)
    outs = []
    for mod in (jts, tts):
        mux = mod.TsMuxer(has_video=True, has_audio=True)
        segs = []
        for s in range(2):          # continuity counters span segments
            video = [mod.TsSample(f, pts=(6 * s + i) * 9000, is_idr=i == 0)
                     for i, f in enumerate(frames[6 * s:6 * s + 6])]
            audio = [mod.TsSample(a, pts=(10 * s + i) * 1920)
                     for i, a in enumerate(adts[10 * s:10 * s + 10])]
            segs.append(mux.mux_segment(video=video, audio=audio))
        outs.append(segs)
    assert outs[0] == outs[1]


def test_ts_tree_video_only_matches_jax(tmp_path, monkeypatch):
    jres, tres = run_both(tmp_path, monkeypatch, 0, n_frames=20,
                          streaming_format="hls_ts")
    _check_ts_tree(tmp_path / "torch")
    assert_same_files(tmp_path / "jax", tmp_path / "torch")
    assert [v.codecs for v in tres.variants] == [v.codecs for v in jres.variants]
    assert tres.resumed_segments == 0


def test_ts_tree_with_muxed_audio_matches_jax(tmp_path, monkeypatch):
    jr, tr = _rungs(96_000)
    adts = {96_000: (_adts_frames(60, seed=1), SR)}
    jres, tres = run_both(tmp_path, monkeypatch, 0, n_frames=20,
                          jax_rungs=jr, torch_rungs=tr, audio_adts=adts,
                          streaming_format="hls_ts")
    files = _check_ts_tree(tmp_path / "torch")
    assert_same_files(tmp_path / "jax", tmp_path / "torch")
    # the 96p variant muxes AAC, the 64p one (no ADTS at its rate) does not
    master = files["master.m3u8"].decode()
    assert master.count("mp4a.40.2") == 1
    by_name = {v.name: v for v in tres.variants}
    assert by_name["96p"].codecs.endswith(",mp4a.40.2")
    assert by_name["96p"].bandwidth == tres.rungs[0].achieved_bitrate + 96_000
    # the audio PID carries ADTS in the first segment
    seg = files["96p/segment_00001.ts"]
    pids = {((seg[i + 1] & 0x1F) << 8) | seg[i + 2] for i in range(0, len(seg), 188)}
    assert 0x0101 in pids


def test_ts_segments_decode_with_libav(tsdec, tmp_path, monkeypatch):  # noqa: F811
    run_both(tmp_path, monkeypatch, 0, n_frames=20, streaming_format="hls_ts")
    rdir = tmp_path / "torch" / "96p"
    cat = tmp_path / "all.ts"
    cat.write_bytes(b"".join(p.read_bytes()
                             for p in sorted(rdir.glob("segment_*.ts"))))
    proc = subprocess.run([str(tsdec), str(cat), str(tmp_path / "d.yuv")],
                          capture_output=True, text=True, check=True)
    assert "video=20" in proc.stdout
