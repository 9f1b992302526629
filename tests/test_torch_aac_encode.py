"""The port's AAC encoder (``vlog_tpu_torch/codecs/aac``): the device MDCT,
the restored Huffman and ADTS writers, and ``AacEncoder`` against the JAX
package's, on the CPU.

Tolerances:
- ``forward_mdct`` (float32 on both sides, sums in other orders) against
  JAX's ``forward_mdct(use_jax=True)``: max |diff| <= 1e-5 of max |X|.
- The Huffman and ADTS writers: identical bits.
- ``encode_frames`` on a seeded broadband signal (tones plus noise, as
  PCM): identical payloads at 96, 128 and 192 kbps, stereo and mono.
- On band-limited input (an AAC track decoded again: its empty bands
  hold only float32 rounding noise of the MDCT, which moves the
  scalefactor reference level) the payloads depend on the float32 sum
  order (ROADMAP Queue C item 13). There the spectra are held to the
  MDCT's bound, and given JAX's spectrum the port's payloads are
  identical: everything after the MDCT is exact.
- Round trip through the port's decoder: SNR above 15 dB at 128 kbps on
  the JAX package's own music-like signal and floor (``tests/test_aac.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vlog_tpu.codecs.aac import AacEncoder as JaxEncoder
from vlog_tpu.codecs.aac import adts as jadts
from vlog_tpu.codecs.aac import huffman as jhuff
from vlog_tpu.codecs.aac import mdct as jmdct
from vlog_tpu.media.bitstream import BitWriter as JaxWriter
from vlog_tpu_torch.codecs.aac import AacEncoder, decode_adts
from vlog_tpu_torch.codecs.aac import adts as tadts
from vlog_tpu_torch.codecs.aac import huffman as thuff
from vlog_tpu_torch.codecs.aac import mdct as tmdct
from vlog_tpu_torch.media.bitstream import BitWriter

SR = 48000
MDCT_REL_TOL = 1e-5


def _broadband(channels: int, seconds: float, seed: int = 0) -> np.ndarray:
    """440 Hz / 1234.5 Hz tones plus white noise, [-1, 1) PCM."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(SR * seconds)) / SR
    tones = (440.0, 1234.5)
    return np.stack([0.3 * np.sin(2 * np.pi * tones[c % 2] * t)
                     + 0.05 * rng.standard_normal(t.size)
                     for c in range(channels)])


def _blocks(kind: str, seed: int) -> np.ndarray:
    """Windowed (2, 24, 2048) blocks at the encoder's 32768 scale."""
    rng = np.random.default_rng(seed)
    from vlog_tpu.codecs.aac.encoder import _frame_blocks

    if kind == "tone":
        t = np.arange(24 * 1024) / SR
        pcm = np.stack([0.4 * np.sin(2 * np.pi * 440 * t),
                        0.4 * np.sin(2 * np.pi * 660 * t)])
    else:
        pcm = rng.uniform(-1, 1, (2, 24 * 1024))
    blocks = np.stack([_frame_blocks(c * 32768.0) for c in pcm])
    return blocks * jmdct.sine_window(2048)


@pytest.mark.parametrize("kind,seed", [("tone", 0), ("noise", 1), ("noise", 2)])
def test_forward_mdct_matches_jax(kind, seed):
    import jax.numpy as jnp

    x = _blocks(kind, seed)
    want = np.asarray(jmdct.forward_mdct(jnp.asarray(x, jnp.float32),
                                         basis=jmdct.mdct_matrix(2048),
                                         use_jax=True))
    got = tmdct.forward_mdct(torch.from_numpy(x.astype(np.float32)))
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float(np.abs(got.numpy() - want).max())
    assert err <= MDCT_REL_TOL * float(np.abs(want).max()), err
    # the float64 reference the float32 products approximate
    exact = jmdct.forward_mdct(x)
    assert np.abs(got.numpy() - exact).max() <= MDCT_REL_TOL * np.abs(exact).max()


def _groups(book: int, rng, n: int = 200) -> list[tuple[int, ...]]:
    """Random coefficient groups the book can code (escapes up to 8191)."""
    dim, _, lav = jhuff.BOOK_INFO[book]
    if book == jhuff.ESC_HCB:
        mags = np.where(rng.random((n, dim)) < 0.3,
                        rng.integers(16, 8192, (n, dim)),
                        rng.integers(0, 17, (n, dim)))
        vals = mags * rng.choice([-1, 1], (n, dim))
    else:
        vals = rng.integers(-lav, lav + 1, (n, dim))
    return [tuple(int(v) for v in row) for row in vals]


@pytest.mark.parametrize("book", list(range(1, 12)))
def test_huffman_writers_match_jax(book):
    rng = np.random.default_rng(book)
    groups = _groups(book, rng)
    jw, tw = JaxWriter(), BitWriter()
    signed = jhuff.BOOK_INFO[book][1]
    for g in groups:
        jhuff.write_group(jw, book, g)
        thuff.write_group(tw, book, g)
        assert thuff.group_bits(book, g) == jhuff.group_bits(book, g)
        coded = g if signed else tuple(min(abs(v), 16) for v in g)
        assert thuff.book_index(book, coded) == jhuff.book_index(book, coded)
    assert tw.bit_length == jw.bit_length
    tw.byte_align()
    jw.byte_align()
    assert tw.getvalue() == jw.getvalue()
    # best_book / smallest_book over bands of this book's range
    for k in range(0, len(groups) - 4, 4):
        band = [v for g in groups[k:k + 4] for v in g][:16]
        band += [0] * (-len(band) % 4)
        assert thuff.best_book(band) == jhuff.best_book(band)
        m = max(abs(v) for v in band)
        assert thuff.smallest_book(m) == jhuff.smallest_book(m)


def test_scalefactor_writers_match_jax():
    jw, tw = JaxWriter(), BitWriter()
    for d in range(-60, 61):
        jhuff.write_scalefactor(jw, d)
        thuff.write_scalefactor(tw, d)
        assert thuff.scalefactor_bits(d) == jhuff.scalefactor_bits(d)
    assert tw.bit_length == jw.bit_length
    tw.byte_align()
    jw.byte_align()
    assert tw.getvalue() == jw.getvalue()
    with pytest.raises(ValueError, match="out of range"):
        thuff.write_scalefactor(BitWriter(), 61)
    for mag in (16, 17, 255, 4096, 8191):
        jw, tw = JaxWriter(), BitWriter()
        jhuff._write_escape(jw, mag)
        thuff._write_escape(tw, mag)
        assert tw.bit_length == jw.bit_length
        tw.byte_align()
        jw.byte_align()
        assert tw.getvalue() == jw.getvalue()
    with pytest.raises(ValueError, match="escape magnitude"):
        thuff._write_escape(BitWriter(), 8192)


@pytest.mark.parametrize("sr,channels", [(48000, 2), (44100, 1), (22050, 2)])
def test_adts_writers_match_jax(sr, channels):
    rng = np.random.default_rng(sr)
    jcfg = jadts.AacConfig(sample_rate=sr, channels=channels)
    tcfg = tadts.AacConfig(sample_rate=sr, channels=channels)
    assert tcfg.audio_specific_config() == jcfg.audio_specific_config()
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
                for n in rng.integers(1, 1500, 20)]
    stream = b"".join(tadts.adts_header(tcfg, len(p)) + p for p in payloads)
    assert stream == b"".join(jadts.adts_header(jcfg, len(p)) + p
                              for p in payloads)
    assert tadts.split_adts_frames(stream) == jadts.split_adts_frames(stream)
    with pytest.raises(ValueError, match="truncated"):
        tadts.split_adts_frames(stream[:-1])
    with pytest.raises(ValueError, match="syncword"):
        tadts.split_adts_frames(b"\x00" + stream)


@pytest.mark.parametrize("bitrate", [96_000, 128_000, 192_000])
@pytest.mark.parametrize("channels", [2, 1])
def test_encode_frames_identical_to_jax(bitrate, channels):
    pcm = _broadband(channels, 0.6, seed=channels)
    want = JaxEncoder(SR, channels, bitrate).encode_frames(pcm)
    enc = AacEncoder(SR, channels, bitrate, device="cpu")
    got = enc.encode_frames(pcm)
    assert len(got) == len(want) == 30
    assert got == want
    jenc = JaxEncoder(SR, channels, bitrate)
    jenc.encode_frames(pcm)
    assert enc._rc.qp == jenc._rc.qp


def test_encode_adts_identical_and_streams_continue():
    """Chunked encoding carries the rate controller across calls."""
    pcm = _broadband(2, 0.8, seed=3)
    jenc, tenc = JaxEncoder(SR, 2, 128_000), AacEncoder(SR, 2, 128_000,
                                                        device="cpu")
    for chunk in (pcm[:, :SR // 4], pcm[:, SR // 4:]):
        assert tenc.encode_adts(chunk) == jenc.encode_adts(chunk)


def _decoded_tone_track() -> np.ndarray:
    """A stereo tone track that went through AAC once (JAX encoder, the
    port's decoder): band-limited, as every MP4 upload's audio is."""
    t = np.arange(SR) / SR
    pcm = np.stack([0.4 * np.sin(2 * np.pi * 440 * t),
                    0.4 * np.sin(2 * np.pi * 660 * t)])
    _, out = decode_adts(JaxEncoder(SR, 2, 128_000).encode_adts(pcm))
    return out


@pytest.mark.parametrize("bitrate", [96_000, 192_000])
def test_band_limited_input_differs_only_by_the_mdct_sums(bitrate,
                                                         monkeypatch):
    pcm = _decoded_tone_track()
    jenc = JaxEncoder(SR, 2, bitrate)
    tenc = AacEncoder(SR, 2, bitrate, device="cpu")
    want_spec, got_spec = jenc._mdct_all(pcm), tenc._mdct_all(pcm)
    assert np.abs(got_spec - want_spec).max() <= \
        MDCT_REL_TOL * np.abs(want_spec).max()
    want = JaxEncoder(SR, 2, bitrate).encode_frames(pcm)
    monkeypatch.setattr(tenc, "_mdct_all", lambda _: want_spec)
    assert tenc.encode_frames(pcm) == want


def test_roundtrip_through_the_port_decoder():
    """The JAX package's own round-trip check (``tests/test_aac.py``:
    its music-like signal, 128 kbps, the 15 dB floor) on the port."""
    from tests.test_aac import music_like

    sig = music_like(SR, 1.5)
    pcm = np.stack([sig, 0.8 * sig])
    cfg, out = decode_adts(AacEncoder(SR, 2, 128_000,
                                      device="cpu").encode_adts(pcm))
    assert (cfg.sample_rate, cfg.channels) == (SR, 2)
    d = 1024
    n = min(out.shape[1] - d, pcm.shape[1])
    err = out[:, d:d + n] - pcm[:, :n]
    snr = 10 * np.log10(np.mean(pcm[:, :n] ** 2) / np.mean(err ** 2))
    assert snr > 15.0, f"round-trip SNR {snr:.1f} dB"


def test_cuda_default_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AacEncoder(SR, 2, 128_000)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AacEncoder(SR, 2, 128_000, device="cuda")
