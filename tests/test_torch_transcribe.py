"""The port's transcription worker (``vlog_tpu_torch/worker/transcribe.py``)
against the JAX package's on the CPU: ``captions.vtt`` byte-identical to
``vlog_tpu.worker.transcribe.transcribe_video`` on a WAV and on an A/V
MP4 (AAC audio), and again after a checkpoint resume (hand-off both
ways), with the defaults of both (language detection, beam 5) and the
shared tiny checkpoint; plus the windowing, stitching and VTT helpers.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

pytest.importorskip("transformers")

from vlog_tpu.asr import engine as jengine
from vlog_tpu.asr import vtt as jvtt
from vlog_tpu.media.audio import AudioData as JAudioData
from vlog_tpu.media.audio import write_wav as jax_write_wav
from vlog_tpu.worker import transcribe as jtr
from vlog_tpu_torch.asr import engine as tengine
from vlog_tpu_torch.asr import vtt as tvtt
from vlog_tpu_torch.worker import transcribe as ttr

MAX_NEW = 8


@pytest.fixture(autouse=True)
def _fresh_engines():
    jengine.reset_engine()
    tengine.reset_engine()
    yield
    jengine.reset_engine()
    tengine.reset_engine()


def _speechlike(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = sum(np.sin(2 * np.pi * f * t) / k
            for k, f in enumerate((160.0, 320.0, 480.0), 1))
    x *= 0.25 * (0.6 + 0.4 * np.sin(2 * np.pi * 3.5 * t))
    return x + rng.normal(0, 0.003, t.size)


def _pair(path, out, model_dir, **kw):
    want = jtr.transcribe_video(path, out / "jax", model_dir=str(model_dir),
                                max_new=MAX_NEW, **kw)
    got = ttr.transcribe_video(path, out / "port", model_dir=str(model_dir),
                               max_new=MAX_NEW, device="cpu", **kw)
    return want, got


def _same(want, got):
    assert (got.language, got.windows, got.cue_count, got.text) == \
        (want.language, want.windows, want.cue_count, want.text)
    with open(got.vtt_path, "rb") as a, open(want.vtt_path, "rb") as b:
        assert a.read() == b.read()


def test_captions_equal_jax_on_a_wav(tmp_path, tiny_model_dir):
    wav = tmp_path / "a.wav"
    jax_write_wav(wav, JAudioData(pcm=_speechlike(65.0)[None],
                                  sample_rate=16000))
    want, got = _pair(wav, tmp_path, tiny_model_dir)
    assert got.windows == 3 and got.cue_count > 0
    _same(want, got)


def test_captions_equal_jax_on_an_av_mp4(tmp_path, tiny_model_dir):
    from test_audio_pipeline import make_av_mp4

    mp4 = make_av_mp4(tmp_path / "av.mp4", seconds=3.0)
    want, got = _pair(mp4, tmp_path, tiny_model_dir)
    assert got.windows == 1
    _same(want, got)


def test_resumed_captions_equal_jax(tmp_path, tiny_model_dir):
    """An attempt stopped after its first window, resumed from the
    JSON-round-tripped checkpoint, writes JAX's uninterrupted bytes; the
    JAX worker resumed from the port's checkpoint writes them too."""
    wav = tmp_path / "a.wav"
    jax_write_wav(wav, JAudioData(pcm=_speechlike(90.0, 1)[None],
                                  sample_rate=16000))
    want = jtr.transcribe_video(wav, tmp_path / "jax", model_dir=str(
        tiny_model_dir), max_new=MAX_NEW)
    states = []

    class Stop(Exception):
        pass

    def checkpoint(state, done, total, final):
        states.append(json.loads(json.dumps(state)))
        if done == 1 and not final:
            raise Stop

    from vlog_tpu_torch.asr.load import load_whisper as port_load

    one_by_one = tengine.AsrEngine(  # slowlane-ok: tiny checkpoint
        port_load(tiny_model_dir, device="cpu"), batch_windows=1, tick_s=0.0)
    try:
        with pytest.raises(Stop):
            ttr.transcribe_video(wav, tmp_path / "cut", model_dir=str(
                tiny_model_dir), max_new=MAX_NEW, device="cpu",
                engine=one_by_one, checkpoint_cb=checkpoint)
    finally:
        one_by_one.close()
    partial = states[-1]
    assert 1 <= len(partial["windows"]) < want.windows
    stats: dict = {}
    got = ttr.transcribe_video(wav, tmp_path / "port", model_dir=str(
        tiny_model_dir), max_new=MAX_NEW, device="cpu", resume=partial,
        stats_out=stats)
    assert stats["windows_resumed"] == len(partial["windows"])
    assert stats["windows_submitted"] < stats["windows_live"]
    _same(want, got)
    jax_res = jtr.transcribe_video(wav, tmp_path / "jax_res", model_dir=str(
        tiny_model_dir), max_new=MAX_NEW, resume=partial)
    _same(want, jax_res)


def test_transcribe_audio_equals_jax(tiny_model_dir):
    from vlog_tpu.asr.load import load_whisper as jax_load
    from vlog_tpu_torch.asr.load import load_whisper as port_load

    samples = _speechlike(40.0, 2).astype(np.float32)
    want = jtr.transcribe_audio(samples, jax_load(tiny_model_dir),
                                max_new=MAX_NEW)
    got = ttr.transcribe_audio(samples, port_load(tiny_model_dir,
                                                  device="cpu"),
                               max_new=MAX_NEW)
    assert got[1] == want[1]
    assert tvtt.format_vtt(got[0]) == jvtt.format_vtt(want[0])
    silent, _ = ttr.transcribe_audio(np.zeros(16000 * 35, np.float32),
                                     port_load(tiny_model_dir, device="cpu"),
                                     language="en", max_new=4)
    assert silent == []


@pytest.mark.parametrize("n", [0, 1, 16000 * 30, 16000 * 31, 16000 * 95 + 7])
def test_cut_windows_equal_jax(n):
    x = np.arange(n, dtype=np.float32)
    want = jtr._cut_windows(x, window_s=30.0, overlap_s=5.0)
    got = ttr._cut_windows(x, window_s=30.0, overlap_s=5.0)
    assert [t for t, _ in got] == [t for t, _ in want]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(got, want))


def test_stitch_and_format_equal_jax():
    rng = np.random.default_rng(4)
    windows = []
    for w in range(5):
        cues = []
        for _ in range(int(rng.integers(0, 5))):
            s = 25.0 * w + float(rng.uniform(0, 28))
            cues.append((s, s + float(rng.uniform(0, 4)),
                         rng.choice(["a & b", " <x> ", "", "text  here"])))
        windows.append(cues)
    got = tvtt.stitch_windows([[tvtt.Cue(*c) for c in w] for w in windows])
    want = jvtt.stitch_windows([[jvtt.Cue(*c) for c in w] for w in windows])
    assert tvtt.format_vtt(got) == jvtt.format_vtt(want)


def test_missing_model_dir_and_device(tmp_path):
    with pytest.raises(ttr.TranscriptionUnavailable, match="VLOG_WHISPER_DIR"):
        ttr.transcribe_video(tmp_path / "a.wav", tmp_path / "out",
                             model_dir=str(tmp_path / "nope"), device="cpu")
    import torch

    if not torch.cuda.is_available():   # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttr.transcribe_video(tmp_path / "a.wav", tmp_path / "out",
                                 model_dir=str(tmp_path))
