"""The port's host AAC decoder and audio ingest (``vlog_tpu_torch/codecs/aac``,
``vlog_tpu_torch/media/audio.py``) against the JAX package's: decoded PCM
identical (``np.array_equal``) from ADTS streams and from an A/V MP4's
AAC track, plus WAV IO, resampling and downmix. The streams come from
the JAX package's AAC encoder.
"""

from __future__ import annotations

import numpy as np
import pytest

from vlog_tpu.codecs.aac import AacEncoder
from vlog_tpu.codecs.aac.decoder import decode_adts as jax_decode_adts
from vlog_tpu.media import audio as jaudio
from vlog_tpu_torch.codecs.aac.decoder import decode_adts
from vlog_tpu_torch.media import audio as taudio


def _music(sr: int, seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    x = sum(np.sin(2 * np.pi * f * t) * a
            for f, a in ((220.0, 0.3), (440.0, 0.2), (1760.0, 0.05)))
    x[int(0.6 * sr):int(0.62 * sr)] += rng.normal(0, 0.4, int(0.02 * sr))
    return x + rng.normal(0, 0.01, t.size)          # a transient: short blocks


@pytest.fixture(scope="module")
def adts_streams():
    out = {}
    for sr, ch, bps in ((48000, 2, 128_000), (44100, 1, 64_000)):
        pcm = np.stack([_music(sr, 1.2, s) for s in range(ch)])
        out[(sr, ch)] = AacEncoder(sample_rate=sr, channels=ch,
                                   bitrate=bps).encode_adts(pcm)
    return out


@pytest.mark.parametrize("key", [(48000, 2), (44100, 1)])
def test_decode_adts_identical(adts_streams, key):
    data = adts_streams[key]
    jcfg, want = jax_decode_adts(data)
    cfg, got = decode_adts(data)
    assert (cfg.sample_rate, cfg.channels) == (jcfg.sample_rate, jcfg.channels)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_extract_audio_from_adts_file_identical(adts_streams, tmp_path):
    path = tmp_path / "a.aac"
    path.write_bytes(adts_streams[(48000, 2)])
    want, got = jaudio.extract_audio(path), taudio.extract_audio(path)
    assert got.sample_rate == want.sample_rate
    assert np.array_equal(got.pcm, want.pcm)


def test_extract_mp4_audio_identical(tmp_path):
    from test_audio_pipeline import make_av_mp4

    mp4 = make_av_mp4(tmp_path / "av.mp4", seconds=1.5)
    want = jaudio.extract_mp4_audio(mp4)
    got = taudio.extract_mp4_audio(mp4)
    assert got.sample_rate == want.sample_rate == 48000
    assert got.pcm.shape == want.pcm.shape and np.array_equal(got.pcm, want.pcm)
    via = taudio.extract_audio(mp4)
    assert np.array_equal(via.pcm, want.pcm)
    # the transcription front end: mono at 16 kHz
    a = taudio.resample(taudio.to_mono(got), 16000)
    b = jaudio.resample(jaudio.to_mono(want), 16000)
    assert a.sample_rate == 16000 and np.array_equal(a.pcm, b.pcm)


def test_wav_roundtrip_identical(tmp_path):
    rng = np.random.default_rng(2)
    pcm = np.clip(rng.normal(0, 0.3, (2, 2205)), -1.2, 1.2)
    taudio.write_wav(tmp_path / "t.wav", taudio.AudioData(pcm, 22050))
    jaudio.write_wav(tmp_path / "j.wav", jaudio.AudioData(pcm, 22050))
    assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    got = taudio.read_wav(tmp_path / "t.wav")
    want = jaudio.read_wav(tmp_path / "t.wav")
    assert got.sample_rate == 22050 and np.array_equal(got.pcm, want.pcm)
    assert taudio.extract_audio(tmp_path / "t.wav").channels == 2
    with pytest.raises(taudio.AudioError):
        (tmp_path / "bad.wav").write_bytes(b"RIFX0000WAVE")
        taudio.read_wav(tmp_path / "bad.wav")
