"""The port's H.264 decoder (``vlog_tpu_torch/codecs/h264/decoder.py``,
host parse + PyTorch reconstruction on the CPU) against the JAX
package's (``vlog_tpu/codecs/h264/decoder.py``).

Streams come from the JAX encoder on seeded numpy frames: CAVLC intra
frames at the sizes and QPs of ``tests/test_h264_decoder.py``, and the
I+P output of ``JaxBackend`` (CABAC and CAVLC, deblocking on, rate
control on, so QPs change per frame). The device functions take
identical seeded numpy level dicts and reference planes. Tolerance:
none: every decoded plane is bit-exact, and both decoders raise the same
exception class with the same message on the same malformed input.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vlog_tpu.codecs.h264 import decoder as jdec
from vlog_tpu.codecs.h264.api import H264Encoder
from vlog_tpu.media.bitstream import BitWriter
from vlog_tpu_torch.codecs.h264 import decoder as tdec

from tests.test_h264_decoder import synth
from tests.test_torch_backend import one_torch_thread  # noqa: F401
from tests.test_torch_mp4 import cmaf_samples, jax_ip_tree


def _planes_equal(jf, tf):
    for name in ("y", "u", "v"):
        a, b = np.asarray(getattr(jf, name)), getattr(tf, name)
        assert isinstance(b, np.ndarray) and b.dtype == np.uint8
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("size", [(16, 16), (48, 64), (144, 176), (34, 50)])
@pytest.mark.parametrize("qp", [12, 26, 40])
def test_cavlc_intra_annexb_bit_exact(size, qp):
    h, w = size
    rng = np.random.default_rng(h * 131 + w + qp)
    y, u, v = synth(rng, h, w)
    [ef] = H264Encoder(width=w, height=h, qp=qp).encode(y[None], u[None], v[None])
    want, jsps = jdec.decode_annexb(ef.annexb)
    got, tsps = tdec.decode_annexb(ef.annexb, device="cpu")
    assert (tsps.width, tsps.height) == (jsps.width, jsps.height) == (w, h)
    assert len(got) == len(want) == 1
    _planes_equal(want[0], got[0])


@pytest.fixture(scope="module", params=["cabac", "cavlc"])
def ip_stream(request, tmp_path_factory):
    """(avcC, samples) of JaxBackend's 20-frame 96x128 I+P rung."""
    from vlog_tpu import config as jconfig

    saved = jconfig.H264_ENTROPY
    jconfig.H264_ENTROPY = request.param
    try:
        rung_dir = jax_ip_tree(tmp_path_factory.mktemp(request.param))
    finally:
        jconfig.H264_ENTROPY = saved
    entry, _, _, samples = cmaf_samples(rung_dir)
    avcc = entry[entry.index(b"avcC") + 4:]
    return avcc, [d for d, _, _ in samples]


def test_ip_stream_decodes_bit_exact(ip_stream):
    avcc, samples = ip_stream
    jd = jdec.H264Decoder(avcc_config=avcc)
    td = tdec.H264Decoder(avcc_config=avcc, device="cpu")
    # the stream exercises P slices, deblocking and per-frame QPs
    levels = [jdec.H264Decoder(avcc_config=avcc).decode_sample_levels(s)
              for s in samples]
    assert sum(lv["is_p"] for lv in levels) == 18
    assert all(lv["deblock"] for lv in levels)
    assert len({lv["qp"] for lv in levels}) > 1
    want = jd.decode_samples(samples[:10]) + [jd.decode_sample(s)
                                              for s in samples[10:]]
    got = td.decode_samples(samples[:10]) + [td.decode_sample(s)
                                             for s in samples[10:]]
    assert len(got) == len(want) == 20
    for jf, tf in zip(want, got):
        _planes_equal(jf, tf)
    assert all(v > 0 for v in td.stage_s.values())
    assert isinstance(td._ref[0], torch.Tensor)      # stays on the device


# ---------------------------------------------------------------------------
# Device functions on identical level dicts
# ---------------------------------------------------------------------------

def _intra_levels(rng, n: int | None, mbh: int, mbw: int) -> dict:
    lead = () if n is None else (n,)

    def lv(shape, hi, p_zero):
        a = rng.integers(-hi, hi + 1, lead + shape).astype(np.int32)
        return np.where(rng.random(a.shape) < p_zero, 0, a).astype(np.int32)

    return {"luma_dc": lv((mbh, mbw, 4, 4), 40, 0.3),
            "luma_ac": lv((mbh, mbw, 4, 4, 4, 4), 6, 0.7),
            "chroma_dc": lv((2, mbh, mbw, 2, 2), 30, 0.3),
            "chroma_ac": lv((2, mbh, mbw, 2, 2, 4, 4), 5, 0.8)}


def _np(planes):
    return [np.asarray(p) for p in planes]


@pytest.mark.parametrize("qp", [14, 31, 45])
def test_reconstruct_frame_bit_exact(qp):
    rng = np.random.default_rng(qp)
    levels = _intra_levels(rng, None, 3, 5)
    want = _np(jdec.reconstruct_frame(levels, qp=qp))
    got = tdec.reconstruct_frame(levels, qp=qp, device="cpu")
    for a, b in zip(want, got):
        assert b.dtype == torch.uint8
        np.testing.assert_array_equal(b.numpy(), a)


def test_reconstruct_gop_bit_exact():
    rng = np.random.default_rng(5)
    levels = _intra_levels(rng, 3, 2, 4)
    want = _np(jdec.reconstruct_gop(levels, qp=27))
    got = tdec.reconstruct_gop(levels, qp=27, device="cpu")
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), a)


def _p_case(seed: int, mbh: int = 3, mbw: int = 4):
    rng = np.random.default_rng(seed)
    h, w = 16 * mbh, 16 * mbw

    def lv(shape, hi, p_zero):
        a = rng.integers(-hi, hi + 1, shape).astype(np.int32)
        return np.where(rng.random(shape) < p_zero, 0, a).astype(np.int32)

    mv = rng.integers(-128, 129, (mbh, mbw, 2)).astype(np.int32)
    # the largest MVs the decoder accepts, at the corner MBs
    mv[0, 0] = (-128, -128)
    mv[0, -1] = (-128, 128)
    mv[-1, 0] = (128, -128)
    mv[-1, -1] = (128, 128)
    levels = {"luma": lv((mbh, mbw, 4, 4, 4, 4), 8, 0.7),
              "chroma_dc": lv((2, mbh, mbw, 2, 2), 20, 0.4),
              "chroma_ac": lv((2, mbh, mbw, 2, 2, 4, 4), 5, 0.8),
              "mv_q": mv}                              # DSP (y, x) order
    ref = (rng.integers(0, 256, (h, w), dtype=np.uint8),
           rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8),
           rng.integers(0, 256, (h // 2, w // 2), dtype=np.uint8))
    return levels, ref


@pytest.mark.parametrize("seed,qp", [(1, 20), (2, 33), (3, 47)])
def test_reconstruct_p_frame_bit_exact(seed, qp):
    levels, ref = _p_case(seed)
    want = _np(jdec.reconstruct_p_frame(levels, *ref, qp=qp))
    got = tdec.reconstruct_p_frame(levels, *ref, qp=qp, device="cpu")
    for a, b in zip(want, got):
        assert b.dtype == torch.uint8
        np.testing.assert_array_equal(b.numpy(), a)


@pytest.mark.parametrize("is_p", [False, True], ids=["intra", "p"])
def test_deblock_step_bit_exact(is_p):
    """The deblock step of ``_reconstruct``: bS from the levels (P) or
    the intra rule, then the wavefront, against JAX's."""
    from vlog_tpu.codecs.h264 import deblock as jdb

    levels, planes = _p_case(7)
    mbh, mbw = levels["luma"].shape[:2]
    if is_p:
        nz = np.any(levels["luma"] != 0, axis=(-1, -2))
        nz4 = nz.transpose(0, 2, 1, 3).reshape(4 * mbh, 4 * mbw)
        bsv, bsh = jdb.p_bs(nz4, levels["mv_q"])
    else:
        bsv, bsh = jdb.intra_bs(mbh, mbw)
    want = _np(jdb.deblock_frame(*planes, qp=34, bs_v=bsv, bs_h=bsh))
    got = tdec.deblock_decoded(*(torch.as_tensor(p) for p in planes), levels,
                               qp=34, is_p=is_p)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), a.astype(np.uint8))


# ---------------------------------------------------------------------------
# Error paths: the same class and message from both decoders
# ---------------------------------------------------------------------------

def _intra_sample(h=32, w=32):
    rng = np.random.default_rng(9)
    y, u, v = synth(rng, h, w)
    enc = H264Encoder(width=w, height=h, qp=26)
    [ef] = enc.encode(y[None], u[None], v[None])
    return enc, ef


def _pps_rbsp(chroma_offset: int) -> bytes:
    bw = BitWriter()
    for val in (0, 0):
        bw.write_ue(val)          # pps_id, sps_id
    bw.write_bits(0, 2)           # entropy, bottom_field_pic_order
    for val in (0, 0, 0):
        bw.write_ue(val)          # slice groups, num_ref_idx l0/l1
    bw.write_bits(0, 3)           # weighted_pred, weighted_bipred
    for val in (0, 0, chroma_offset):
        bw.write_se(val)
    bw.write_bits(0, 3)
    bw.rbsp_trailing_bits()
    return bw.getvalue()


def _sps_rbsp(frame_mbs_only: int) -> bytes:
    bw = BitWriter()
    bw.write_bits(66, 8)
    bw.write_bits(0, 8)
    bw.write_bits(30, 8)
    for val in (0, 0, 2, 1):      # sps_id, log2_mfn-4, poc type 2, refs
        bw.write_ue(val)
    bw.write_bits(0, 1)
    bw.write_ue(1)                # width in MBs - 1
    bw.write_ue(1)                # height in map units - 1
    bw.write_bits(frame_mbs_only, 1)
    bw.write_bits(0, 1)
    bw.write_bits(0, 1)           # no cropping
    bw.rbsp_trailing_bits()
    return bw.getvalue()


def _error_cases():
    enc, ef = _intra_sample()
    avcc = enc.avcc_config
    nals = jdec.split_annexb(ef.annexb)
    idr = next(r for t, _, r in nals if t == 5)

    def p_without_reference(mod, device):
        # an I sample decoded as if its slice were P: no reference yet
        dec = mod.H264Decoder(avcc_config=avcc, **device)
        levels = dec.decode_sample_levels(ef.avcc)
        levels["is_p"] = True
        dec._reconstruct(levels)

    def mv_beyond_padding(mod, device):
        dec = mod.H264Decoder(avcc_config=avcc, **device)
        dec.decode_sample(ef.avcc)
        mv = np.zeros((2, 2, 2), np.int32)
        mv[1, 0] = (0, 129)
        dec._reconstruct({"luma": np.zeros((2, 2, 4, 4, 4, 4), np.int32),
                          "chroma_dc": np.zeros((2, 2, 2, 2, 2), np.int32),
                          "chroma_ac": np.zeros((2, 2, 2, 2, 2, 4, 4), np.int32),
                          "mv_q": mv, "qp": 26, "deblock": False, "is_p": True})

    return {
        "bad_avcc_version": lambda m, d: m.H264Decoder(
            avcc_config=b"\x02" + avcc[1:], **d),
        "truncated_avcc": lambda m, d: m.H264Decoder(
            avcc_config=avcc[:9], **d),
        "slice_before_sps": lambda m, d: m.H264Decoder(**d)._decode_slice_nal(
            5, 3, idr),
        "bad_avcc_length": lambda m, d: m.H264Decoder(
            avcc_config=avcc, **d).decode_sample(b"\x00\x00\x10\x00ab"),
        "p_without_reference": p_without_reference,
        "mv_beyond_padding": mv_beyond_padding,
        "chroma_qp_offset": lambda m, d: m.parse_pps(_pps_rbsp(2)),
        "interlaced_sps": lambda m, d: m.parse_sps(_sps_rbsp(0)),
        "truncated_slice": lambda m, d: m.H264Decoder(
            avcc_config=avcc, **d).decode_sample(
                len(ef.avcc[4:40]).to_bytes(4, "big") + ef.avcc[4:40]),
    }


_CASES = _error_cases()


@pytest.mark.parametrize("case", sorted(_CASES))
def test_error_paths_match_jax(case):
    fn = _CASES[case]
    with pytest.raises(Exception) as ej:
        fn(jdec, {})
    with pytest.raises(Exception) as et:
        fn(tdec, {"device": "cpu"})
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value) == str(ej.value)
    if isinstance(ej.value, jdec.DecodeError):
        assert isinstance(et.value, tdec.DecodeError)
        assert isinstance(et.value, tdec.UnsupportedStream) == \
            isinstance(ej.value, jdec.UnsupportedStream)


def test_decoder_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdec.H264Decoder()
