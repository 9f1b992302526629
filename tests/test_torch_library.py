"""The port's library surface against the JAX package's, on numpy inputs
made from a seed:

- ``H264Encoder.encode``: equal AVCC and Annex-B bytes (CAVLC and CABAC,
  IDR period 1 and 3, whole macroblocks and a size that is not, two
  successive calls), ``psnr_y`` within 1e-9; the streams decode with the
  port's decoder, and with the libavcodec oracle of
  ``tests/test_h264_oracle.py`` where it builds, to the encoder's
  reconstruction;
- ``headers_annexb``, ``avcc_config``, ``codec_string`` and the fMP4
  helpers: equal bytes;
- ``encode_gop``, ``pad_to_mb``, ``frame_levels``, ``p_frame_levels``:
  bit-exact integer arrays;
- the one-call resize API (``resize_plane``, ``resize_yuv420``,
  ``ladder_resize_yuv420``): uint8 within ROADMAP Queue C item 1's bound
  (|diff| <= 1, at most 0.1% of pixels), float32 within rtol 1e-5, the
  identity size and the odd-size ``ValueError`` as JAX's; a uint8 plane
  goes through the kernel's wrapper;
- the colour conversions: bit-exact;
- ``single_chip_ladder``: the levels and reconstructions of JAX's
  ``single_chip_ladder(pallas=False)`` on a seed where the resized planes
  agree;
- ``failpoints.disarm`` and ``arm_from_env``: JAX's counters.

The ladder's intra, TS and resume trees, which share ``H264Encoder``'s
numbering with ``encode``, stay held to JAX's by
``tests/test_torch_intra.py``, ``test_torch_ts.py`` and
``test_torch_resume.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

# the libavcodec oracle (skips where it does not build)
from tests.test_h264_oracle import avdec, oracle_decode  # noqa: F401

MAX_SHARE = 1e-3
_SIZES = ((64, 96), (56, 88))        # (height, width); 56x88 pads to 64x96


def _planes(seed: int, n: int, h: int, w: int):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    # smooth the luma so the levels are not all escapes
    y = ((y.astype(np.int32) + np.roll(y, 1, -1) + np.roll(y, 1, -2)) // 3
         ).astype(np.uint8)
    u = rng.integers(90, 166, (n, h // 2, w // 2), dtype=np.uint8)
    v = rng.integers(90, 166, (n, h // 2, w // 2), dtype=np.uint8)
    return y, u, v


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _close_u8(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max(initial=0) <= 1
    assert (diff > 0).mean() <= MAX_SHARE


# --- H264Encoder ---------------------------------------------------------

@pytest.mark.parametrize("size", _SIZES)
@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
@pytest.mark.parametrize("idr_period", [1, 3])
def test_encode_gives_jax_bytes(size, entropy, idr_period):
    from vlog_tpu.codecs.h264.api import H264Encoder as JaxEncoder
    from vlog_tpu_torch.codecs.h264.api import H264Encoder

    h, w = size
    jax_enc = JaxEncoder(width=w, height=h, qp=28, entropy=entropy,
                         idr_period=idr_period, entropy_threads=2)
    enc = H264Encoder(width=w, height=h, qp=28, entropy=entropy,
                      idr_period=idr_period, entropy_threads=2,
                      device="cpu")
    idrs = []
    for call in range(2):          # the numbering runs on across calls
        y, u, v = _planes(10 * call + h, 4, h, w)
        want, got = jax_enc.encode(y, u, v), enc.encode(y, u, v)
        assert len(got) == len(want) == 4
        for i, (g, j) in enumerate(zip(got, want)):
            assert g.avcc == j.avcc, (call, i)
            assert g.annexb == j.annexb, (call, i)
            assert g.is_idr == j.is_idr
            assert abs(g.psnr_y - j.psnr_y) <= 1e-9
        idrs += [g.is_idr for g in got]
    assert idrs == [i % idr_period == 0 for i in range(8)]


@pytest.mark.parametrize("entropy", ["cavlc", "cabac"])
def test_headers_and_configs_match_jax(entropy):
    from vlog_tpu.codecs.h264.api import H264Encoder as JaxEncoder
    from vlog_tpu.media import fmp4 as jfmp4
    from vlog_tpu_torch.codecs.h264 import avcc_config, syntax
    from vlog_tpu_torch.codecs.h264.api import H264Encoder
    from vlog_tpu_torch.media import fmp4

    jax_enc = JaxEncoder(width=88, height=56, qp=30, entropy=entropy)
    enc = H264Encoder(width=88, height=56, qp=30, entropy=entropy,
                      device="cpu")
    assert enc.headers_annexb() == jax_enc.headers_annexb()
    assert enc.headers_annexb() == syntax.annexb([enc.sps, enc.pps])
    assert enc.avcc_config == jax_enc.avcc_config
    assert enc.codec_string == jax_enc.codec_string
    # the media layer's record takes the NAL units' bytes
    sps, pps = enc.sps.to_bytes(), enc.pps.to_bytes()
    record = fmp4.avcc_config(sps, pps)
    assert record == jfmp4.avcc_config(jax_enc.sps.to_bytes(),
                                       jax_enc.pps.to_bytes())
    assert record == avcc_config(enc.sps, enc.pps) == enc.avcc_config
    entry = fmp4.avc1_sample_entry(88, 56, record)
    assert fmp4.raw_sample_entry(entry) == jfmp4.raw_sample_entry(entry)
    assert fmp4.raw_sample_entry(entry) is entry


def test_encode_defaults_match_jax():
    from vlog_tpu import config as jconfig
    from vlog_tpu.codecs.h264.api import H264Encoder as JaxEncoder
    from vlog_tpu_torch import config
    from vlog_tpu_torch.codecs.h264.api import H264Encoder

    enc, jax_enc = H264Encoder(96, 64), JaxEncoder(96, 64)
    assert (enc.idr_period, enc.entropy, enc.qp) == (
        jax_enc.idr_period, jax_enc.entropy, jax_enc.qp)
    assert enc.entropy_threads == config.ENTROPY_THREADS \
        == jconfig.ENTROPY_THREADS == jax_enc.entropy_threads
    assert enc.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            enc.encode(*_planes(0, 1, 64, 96))


def _recon(y, u, v, qp: int, h: int, w: int):
    """The port's reconstruction of ``encode``'s frames (padded, encoded
    at ``qp``, cropped to the display size)."""
    from vlog_tpu_torch.codecs.h264.encoder import encode_gop, pad_to_mb

    out = encode_gop(*_t(pad_to_mb(y), pad_to_mb(u, 8), pad_to_mb(v, 8)),
                     qp=qp)
    return (out["recon_y"][:, :h, :w].numpy(),
            out["recon_u"][:, :h // 2, :w // 2].numpy(),
            out["recon_v"][:, :h // 2, :w // 2].numpy())


@pytest.mark.parametrize("entropy,idr_period", [("cavlc", 1), ("cabac", 3)])
def test_encode_streams_decode_to_the_reconstruction(entropy, idr_period):
    from vlog_tpu_torch.codecs.h264.api import H264Encoder
    from vlog_tpu_torch.codecs.h264.decoder import decode_annexb

    h, w = 56, 88
    y, u, v = _planes(3, 4, h, w)
    enc = H264Encoder(width=w, height=h, qp=26, entropy=entropy,
                      idr_period=idr_period, device="cpu")
    frames = enc.encode(y, u, v)
    decoded, sps = decode_annexb(b"".join(f.annexb for f in frames),
                                 device="cpu")
    assert (sps.height, sps.width) == (h, w) and len(decoded) == 4
    ry, ru, rv = _recon(y, u, v, 26, h, w)
    for i, (d, f) in enumerate(zip(decoded, frames)):
        np.testing.assert_array_equal(d.y, ry[i])
        np.testing.assert_array_equal(d.u, ru[i])
        np.testing.assert_array_equal(d.v, rv[i])
        mse = np.mean((d.y.astype(np.float64) - y[i]) ** 2)
        assert abs(10 * np.log10(255 ** 2 / mse) - f.psnr_y) <= 1e-9


def test_encode_streams_decode_in_libavcodec(avdec, tmp_path):
    from vlog_tpu_torch.codecs.h264.api import H264Encoder

    h, w = 56, 88
    y, u, v = _planes(5, 4, h, w)
    enc = H264Encoder(width=w, height=h, qp=24, idr_period=3,
                      device="cpu")
    frames = enc.encode(y, u, v)
    assert [f.is_idr for f in frames] == [True, False, False, True]
    decoded = oracle_decode(avdec, b"".join(f.annexb for f in frames), h, w,
                            tmp_path)
    ry, ru, rv = _recon(y, u, v, 24, h, w)
    assert len(decoded) == 4
    for i, (dy, du, dv) in enumerate(decoded):
        np.testing.assert_array_equal(dy, ry[i])
        np.testing.assert_array_equal(du, ru[i])
        np.testing.assert_array_equal(dv, rv[i])


# --- the DSP helpers -------------------------------------------------------

def test_encode_gop_and_frame_levels_are_bit_exact():
    from vlog_tpu.codecs.h264 import encoder as jenc
    from vlog_tpu_torch.codecs.h264 import encoder as enc

    y, u, v = _planes(7, 3, 48, 64)
    for qp in (27, np.array([22, 30, 38], np.int32)):
        want = jenc.encode_gop(y, u, v, qp=qp)
        got = enc.encode_gop(*_t(y, u, v), qp=qp)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=k)
        for i in range(3):
            q = int(np.broadcast_to(qp, (3,))[i])
            g = enc.frame_levels({k: t[i] for k, t in got.items()}, q)
            j = jenc.frame_levels({k: a[i] for k, a in want.items()}, q)
            assert g.qp == j.qp == q
            for k in ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac"):
                a, b = getattr(g, k), getattr(j, k)
                assert isinstance(a, np.ndarray) and a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape,mb", [((3, 56, 88), 16), ((28, 44), 8),
                                      ((2, 64, 96), 16), ((1, 17, 31), 16)])
def test_pad_to_mb_matches_jax(shape, mb):
    from vlog_tpu.codecs.h264.encoder import pad_to_mb as jax_pad
    from vlog_tpu_torch.codecs.h264.encoder import pad_to_mb

    x = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                   dtype=np.uint8)
    got, want = pad_to_mb(x, mb), jax_pad(x, mb)
    assert got.shape[-2] % mb == 0 and got.shape[-1] % mb == 0
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_p_frame_levels_match_jax():
    import jax

    from vlog_tpu.codecs.h264 import inter as jinter
    from vlog_tpu_torch.codecs.h264 import inter
    from vlog_tpu_torch.codecs.h264.encoder import encode_frame

    y, u, v = _planes(11, 2, 32, 48)
    i_out = encode_frame(*_t(y[:1], u[:1], v[:1]), qp=26)
    ref = [i_out[k][0].numpy() for k in ("recon_y", "recon_u", "recon_v")]
    jfn = jax.jit(functools.partial(jinter.encode_p_frame, qp=26, search=8))
    want = jinter.p_frame_levels(jfn(y[1], u[1], v[1], *ref))
    got = inter.encode_p_frame(*_t(y[1:], u[1:], v[1:]),
                               *(t[:1] for t in (i_out["recon_y"],
                                                 i_out["recon_u"],
                                                 i_out["recon_v"])),
                               qp=26, search=8)
    got = inter.p_frame_levels({k: t[0] for k, t in got.items()})
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- the resize API --------------------------------------------------------

_SRC = (64, 96)


@pytest.mark.parametrize("dst", [(48, 64), (24, 32), (36, 54), (80, 120)])
@pytest.mark.parametrize("filt", ["lanczos3", "bilinear", "box"])
def test_resize_plane_matches_jax(dst, filt):
    import jax.numpy as jnp

    from vlog_tpu.ops.resize import resize_plane as jax_resize
    from vlog_tpu_torch.ops.resize import resize_plane

    y, _, _ = _planes(21, 2, *_SRC)
    got = resize_plane(torch.from_numpy(y), *dst, filter=filt)
    _close_u8(got.numpy(), np.asarray(jax_resize(y, *dst, filter=filt)))
    got = resize_plane(torch.from_numpy(y), *dst, filter=filt,
                       out_dtype=torch.float32)
    want = np.asarray(jax_resize(y, *dst, filter=filt,
                                 out_dtype=jnp.float32))
    assert got.dtype == torch.float32
    # rtol 1e-5; atol a few float32 ulps at 255 for values near 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def test_resize_yuv420_matches_jax():
    from vlog_tpu.ops.resize import resize_yuv420 as jax_resize
    from vlog_tpu_torch.ops.resize import resize_yuv420

    y, u, v = _planes(22, 3, *_SRC)
    for dst in ((48, 64), (32, 48), (48, 54)):
        got = resize_yuv420(*_t(y, u, v), *dst)
        for g, j in zip(got, jax_resize(y, u, v, *dst)):
            _close_u8(g.numpy(), np.asarray(j))
    # a float source resized: the products, rounded and clipped to uint8
    got = resize_yuv420(*_t(*(p.astype(np.float32) * 1.1 for p in (y, u, v))),
                        32, 48)
    want = jax_resize(*(p.astype(np.float32) * 1.1 for p in (y, u, v)), 32, 48)
    for g, j in zip(got, want):
        _close_u8(g.numpy(), np.asarray(j))


def test_resize_yuv420_identity_and_odd_sizes():
    from vlog_tpu.ops.resize import resize_yuv420 as jax_resize
    from vlog_tpu_torch.ops.resize import resize_yuv420

    y, u, v = _t(*_planes(23, 2, *_SRC))
    got = resize_yuv420(y, u, v, *_SRC)
    assert all(g is p for g, p in zip(got, (y, u, v)))
    # float planes at the identity size keep the uint8 contract
    f = [p.numpy().astype(np.float32) * 1.3 - 20.25 for p in (y, u, v)]
    got = resize_yuv420(*_t(*f), *_SRC)
    for g, j in zip(got, jax_resize(*f, *_SRC)):
        assert g.dtype == torch.uint8
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    for dst in ((47, 64), (48, 63)):
        with pytest.raises(ValueError, match="must be even"):
            jax_resize(*(p.numpy() for p in (y, u, v)), *dst)
        with pytest.raises(ValueError, match="must be even"):
            resize_yuv420(y, u, v, *dst)


def test_ladder_resize_yuv420_matches_jax(monkeypatch):
    from vlog_tpu.ops import ladder_resize_yuv420 as jax_ladder
    from vlog_tpu_torch.ops import fused_resize, ladder_resize_yuv420

    calls = []
    real = fused_resize.fused_resize_plane

    def counted(plane, a_h, a_w):
        calls.append((tuple(plane.shape), a_h, a_w))
        return real(plane, a_h, a_w)

    monkeypatch.setattr(fused_resize, "fused_resize_plane", counted)
    y, u, v = _planes(24, 3, *_SRC)
    rungs = (_SRC, (48, 64), (32, 48), (24, 32))
    want = jax_ladder(y, u, v, rungs)
    got = ladder_resize_yuv420(*_t(y, u, v), rungs)
    assert list(got) == list(want) == list(rungs)
    for hw in rungs:
        for g, j in zip(got[hw], want[hw]):
            _close_u8(g.numpy(), np.asarray(j))
    # every uint8 plane of a scaled rung went through the kernel's
    # wrapper (the plain version on a CPU tensor); the identity none
    assert len(calls) == 3 * (len(rungs) - 1)
    # the matrices are built once per key: a second call reuses them, so
    # the kernel's band form is derived once per matrix on the card
    first = [c[1:] for c in calls]
    calls.clear()
    ladder_resize_yuv420(*_t(y, u, v), rungs)
    assert all(a is c and b is d for (a, b), (c, d) in
               zip(first, (c[1:] for c in calls)))


def test_resize_plane_on_a_cpu_tensor_is_the_plain_version():
    from vlog_tpu_torch.ops.resize import (apply_resize_matrices,
                                           resample_matrix, resize_plane)

    y = torch.from_numpy(_planes(25, 1, *_SRC)[0])
    want = apply_resize_matrices(y, torch.from_numpy(resample_matrix(64, 32)),
                                 torch.from_numpy(resample_matrix(96, 48)))
    assert torch.equal(resize_plane(y, 32, 48), want)


# --- colour conversions ----------------------------------------------------

def test_colour_conversions_are_bit_exact():
    from vlog_tpu.ops import yuv420_to_yuv444 as j420_444
    from vlog_tpu.ops import yuv444_to_yuv420 as j444_420
    from vlog_tpu_torch.ops import yuv420_to_yuv444, yuv444_to_yuv420

    y, u, v = _planes(31, 2, 32, 48)
    got, want = yuv420_to_yuv444(*_t(y, u, v)), j420_444(y, u, v)
    for g, j in zip(got, want):
        assert g.dtype == torch.uint8 and g.shape == tuple(j.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    rng = np.random.default_rng(32)
    y4, u4, v4 = (rng.integers(0, 256, (2, 32, 48), dtype=np.uint8)
                  for _ in range(3))
    got, want = yuv444_to_yuv420(*_t(y4, u4, v4)), j444_420(y4, u4, v4)
    for g, j in zip(got, want):
        assert g.dtype == torch.uint8 and g.shape == tuple(j.shape)
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    # 4:2:0 -> 4:4:4 -> 4:2:0 is the identity
    back = yuv444_to_yuv420(*yuv420_to_yuv444(*_t(y, u, v)))
    for g, p in zip(back, (y, u, v)):
        np.testing.assert_array_equal(g.numpy(), p)


# --- single_chip_ladder ----------------------------------------------------

_LADDER = (("96p", 96, 128, 30), ("64p", 64, 86, 32), ("48p", 48, 64, 34))


def test_single_chip_ladder_matches_jax():
    from vlog_tpu.ops.resize import resize_yuv420 as jax_resize
    from vlog_tpu.parallel.ladder import single_chip_ladder as jax_ladder
    from vlog_tpu_torch.ops.resize import resize_yuv420
    from vlog_tpu_torch.parallel import single_chip_ladder

    y, u, v = _planes(4, 2, 96, 128)
    # the seed: every rung's resized planes agree (Queue C item 1)
    for _, h, w, _ in _LADDER:
        for g, j in zip(resize_yuv420(*_t(y, u, v), h, w),
                        jax_resize(y, u, v, h, w)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    jfn, jmats = jax_ladder(_LADDER, 96, 128, pallas=False)
    want = jfn(y, u, v, jmats)
    fn, mats = single_chip_ladder(_LADDER, 96, 128, device="cpu")
    assert mats["96p"] is None and mats["48p"][0][0].dtype == torch.float32
    got = fn(*_t(y, u, v), mats)
    assert list(got) == [r[0] for r in _LADDER]
    for name in got:
        assert set(got[name]) == set(want[name])
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k].numpy(),
                                          np.asarray(want[name][k]),
                                          err_msg=f"{name} {k}")


def test_single_chip_ladder_takes_no_switch():
    import inspect

    from vlog_tpu_torch.parallel.ladder import single_chip_ladder

    assert "pallas" not in inspect.signature(single_chip_ladder).parameters
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            single_chip_ladder(_LADDER, 96, 128)


# --- failpoints ------------------------------------------------------------

def test_disarm_and_arm_from_env_match_jax(monkeypatch):
    from vlog_tpu.utils import failpoints as jfp
    from vlog_tpu_torch.utils import failpoints as fp

    spec = "backend.pull=2,device.fault=skip1:1;claims.claim=p1.0"
    monkeypatch.setenv(fp.ENV_VAR, spec)
    monkeypatch.setenv(fp.SEED_VAR, "3")
    try:
        seen = []
        for mod in (jfp, fp):
            mod.reset()
            armed = mod.arm_from_env()
            for site in ("backend.pull", "device.fault", "claims.claim") * 3:
                try:
                    mod.hit(site)
                except mod.FailpointError:
                    pass
            before = mod.counters()
            mod.disarm("device.fault")
            mod.disarm("not.armed")           # no error, as the reference
            seen.append((armed, before, mod.counters(),
                         mod.is_armed("device.fault")))
        assert seen[0] == seen[1]
        assert seen[1][3] is False and "device.fault" in seen[1][1]
        monkeypatch.delenv(fp.ENV_VAR)
        assert fp.arm_from_env() == jfp.arm_from_env() == []
    finally:
        jfp.reset()
        fp.reset()
