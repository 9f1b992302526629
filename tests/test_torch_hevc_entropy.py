"""The port's HEVC entropy stage and stream envelope on the CPU: the C
coder's I and P payloads against the JAX package's (same levels), the
port's Python writers against its C coder, the hvcC record and codec
string, and the port's streams through the libavcodec oracle
(``tests/fixtures/avdec.c``, as ``tests/test_hevc.py`` builds it).

Tolerance: exact. Payloads and sample bytes are compared byte for byte;
the oracle's decoded planes must equal the port's own reconstruction
pixel for pixel (deblocking on, so the decoder runs spec 8.7.2 too).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_hevc import hevcdec, oracle_decode  # noqa: F401
from tests.test_torch_backend import one_torch_thread  # noqa: F401
from tests.test_torch_hevc_inter import SEARCH, content

I32 = torch.int32


def _t(a, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def device_chain(kind: str, partitions: bool, deblock: bool = True,
                 qp: int = 30):
    """One 4-frame chain through the port's DSP: numpy host outputs in
    the shapes ``entropy_chain`` takes, plus the reconstructions."""
    from vlog_tpu_torch.codecs.hevc.core import encode_chain_dsp

    y, u, v = content(kind)
    (intra, rec0), (p32, p16, parts, mvs, precons) = encode_chain_dsp(
        _t(y[None]), _t(u[None]), _t(v[None]), SEARCH,
        _t([qp - 2], I32), _t([[qp] * 3], I32), partitions, deblock)

    def host(ts):
        return None if ts is None else tuple(a[0].numpy() for a in ts)

    recons = [tuple(p[0].numpy() for p in rec0)] + [
        tuple(p[0, k].numpy() for p in precons) for k in range(3)]
    return dict(intra=host(intra), p32=host(p32), p16=host(p16),
                parts=parts[0].numpy() if partitions else None,
                mvs=mvs[0].numpy(), recons=recons, frames=(y, u, v))


@pytest.mark.parametrize("partitions", [False, True])
def test_entropy_chain_equals_jax(partitions):
    """Both packages' ``entropy_chain`` on the same device outputs: the
    same samples, Annex-B units and key flags (the C coder for I and
    all-2Nx2N P slices, the Python writer for partitioned ones)."""
    from vlog_tpu.codecs.hevc.api import HevcEncoder as JEnc
    from vlog_tpu_torch.codecs.hevc.api import HevcEncoder as TEnc

    d = device_chain("split", partitions)
    y = d["frames"][0]
    if partitions:
        assert (d["parts"] != 0).any()
    fqs = np.array([30, 30, 31, 29], np.int32)
    psnrs = np.array([40.0, 41.5, 39.25, 38.0])
    args = (d["intra"], d["p32"], d["p16"], d["parts"], d["mvs"], fqs,
            y.shape[1] // 32, y.shape[2] // 32, psnrs)
    want = JEnc(width=y.shape[2], height=y.shape[1]).entropy_chain(
        *args, t_real=4)
    got = TEnc(width=y.shape[2], height=y.shape[1], device="cpu"
               ).entropy_chain(*args, t_real=4)
    assert len(got) == len(want) == 4
    for a, b in zip(want, got):
        assert (b.sample, b.annexb, b.is_idr, b.psnr_y) == \
            (a.sample, a.annexb, a.is_idr, a.psnr_y)


@pytest.mark.parametrize("qp", [12, 30, 51])
def test_c_payloads_equal_python_writers(qp):
    """The port's C coder and its Python writers (SliceWriter for I,
    PSliceWriter for all-2Nx2N P) emit the same payload bytes."""
    from vlog_tpu_torch.codecs.hevc.api import (encode_i_payload,
                                                encode_p_payload)
    from vlog_tpu_torch.codecs.hevc.pslice import PSliceWriter
    from vlog_tpu_torch.codecs.hevc.slice import SliceWriter

    d = device_chain("moving", False, qp=qp)
    ly, lu, lv = d["intra"]
    rows, cols = ly.shape[:2]
    sw = SliceWriter(qp)
    for r in range(rows):
        for c in range(cols):
            sw.write_ctu(c, ly[r, c], lu[r, c], lv[r, c],
                         last_in_slice=(r == rows - 1 and c == cols - 1))
    assert encode_i_payload(ly, lu, lv, rows, cols, qp) == sw.payload()
    for k in range(3):
        l32 = tuple(a[k] for a in d["p32"])
        mvg = d["mvs"][k]
        pw = PSliceWriter(qp, rows, cols)
        for r in range(rows):
            for c in range(cols):
                pw.write_ctu_inter(
                    r, c, tuple(int(x) for x in mvg[2 * r, 2 * c]),
                    l32[0][r, c], l32[1][r, c], l32[2][r, c],
                    last_in_slice=(r == rows - 1 and c == cols - 1))
        assert encode_p_payload(*l32, mvg, rows, cols, qp) == pw.payload()


@pytest.mark.parametrize("w,h", [(96, 64), (640, 360), (1920, 1080)])
@pytest.mark.parametrize("deblock", [False, True])
def test_hvcc_and_codec_string_equal_jax(w, h, deblock):
    from vlog_tpu.codecs.hevc.api import HevcEncoder as JEnc
    from vlog_tpu.media.fmp4 import hvc1_sample_entry as jentry
    from vlog_tpu_torch.codecs.hevc.api import HevcEncoder as TEnc
    from vlog_tpu_torch.media.fmp4 import hvc1_sample_entry as tentry

    je = JEnc(width=w, height=h, deblock=deblock)
    te = TEnc(width=w, height=h, deblock=deblock, device="cpu")
    assert te.hvcc_config == je.hvcc_config
    assert te.codec_string == je.codec_string
    assert te.headers_annexb() == je.headers_annexb()
    assert tentry(w, h, te.hvcc_config) == jentry(w, h, je.hvcc_config)


def test_port_mp4_reader_parses_hvc1(tmp_path):
    """The port's MP4 reader takes an hvc1 track (codec and hvcC)."""
    from vlog_tpu_torch.codecs.hevc.api import HevcEncoder
    from vlog_tpu_torch.media.fmp4 import (Sample, TrackConfig,
                                           hvc1_sample_entry, progressive_mp4)
    from vlog_tpu_torch.media.mp4 import parse_mp4

    enc = HevcEncoder(width=96, height=64, device="cpu")
    track = TrackConfig(track_id=1, handler="vide", timescale=24000,
                        sample_entry=hvc1_sample_entry(96, 64, enc.hvcc_config),
                        width=96, height=64)
    path = tmp_path / "h.mp4"
    path.write_bytes(progressive_mp4(track, [Sample(b"\0\0\0\1\2", 1000)]))
    (trk,) = parse_mp4(path).tracks
    assert (trk.codec, trk.sample_entry_type, trk.codec_config) == \
        ("hevc", "hvc1", enc.hvcc_config)
    assert (trk.width, trk.height) == (96, 64)


def _decode_matches_recon(hevcdec, tmp_path, frames, recons):  # noqa: F811
    annexb = b"".join(f.annexb for f in frames)
    h, w = recons[0][0].shape
    decoded = oracle_decode(hevcdec, annexb, h, w, tmp_path)
    assert len(decoded) == len(recons)
    for got, want in zip(decoded, recons):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,partitions", [("moving", False),
                                             ("split", True)])
def test_oracle_decodes_to_port_recon(hevcdec, tmp_path, kind,  # noqa: F811
                                      partitions):
    """An I+P chain from the port's encoder (deblock on; with
    partitions on split motion) decodes under libavcodec to the
    reconstruction the port's DSP holds."""
    from vlog_tpu_torch.codecs.hevc.api import HevcEncoder

    d = device_chain(kind, partitions)
    y, u, v = d["frames"]
    enc = HevcEncoder(width=y.shape[2], height=y.shape[1], qp=30,
                      deblock=True, device="cpu")
    frames = enc.encode_chain(y, u, v, search=SEARCH, partitions=partitions)
    assert [f.is_idr for f in frames] == [True, False, False, False]
    _decode_matches_recon(hevcdec, tmp_path, frames, d["recons"])


def test_oracle_decodes_intra_batch(hevcdec, tmp_path):  # noqa: F811
    """``encode_batch`` (every frame an IDR, chroma deblocked too)."""
    from vlog_tpu_torch.codecs.hevc.api import HevcEncoder
    from vlog_tpu_torch.codecs.hevc.core import encode_frame_dsp

    y, u, v = content("moving")
    enc = HevcEncoder(width=96, height=64, qp=37, deblock=True, device="cpu")
    frames = enc.encode_batch(y, u, v)
    _, rec = encode_frame_dsp(_t(y), _t(u), _t(v), _t([37] * 4, I32),
                              deblock=True)
    _decode_matches_recon(hevcdec, tmp_path, frames,
                          [tuple(p[i].numpy() for p in rec) for i in range(4)])


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """No fallback: when the C coder cannot be built the entropy call
    raises instead of switching to the Python writers."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.codecs.hevc.api import encode_i_payload
    from vlog_tpu_torch.native import build

    monkeypatch.setattr(build, "_LIB", None)
    # an empty build directory (parallel/compile_cache.py): a build runs
    monkeypatch.setattr(config, "COMPILE_CACHE_DIR", str(tmp_path / "nobuild"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    z = np.zeros((1, 1, 32, 32), np.int16)
    c = np.zeros((1, 1, 16, 16), np.int16)
    with pytest.raises(build.NativeBuildError):
        encode_i_payload(z, c, c, 1, 1, 30)


def test_cuda_default_raises_without_cuda():
    from vlog_tpu_torch.codecs.hevc.api import HevcEncoder

    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        HevcEncoder(width=96, height=64)
