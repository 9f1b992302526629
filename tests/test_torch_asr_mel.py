"""The port's log-mel frontend (``vlog_tpu_torch/asr/mel.py``) against the
JAX package's on the same seeded audio, on the CPU.

Tolerance: max |diff| <= 1e-4 on the (x + 4) / 4 features (about [-1, 2]):
both are float32 FFTs and one matmul whose sums run in other orders.
The filter bank is the same numpy construction, so it is identical.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from vlog_tpu.asr import mel as jmel
from vlog_tpu_torch.asr import mel as tmel

MEL_MAX_ABS = 1e-4


def _speechlike(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6)) / k
            for k, f in enumerate((140.0, 280.0, 420.0, 1100.0), 1))
    x *= 0.2 * (1 + np.sin(2 * np.pi * 4 * t))
    return (x + rng.normal(0, 0.01, t.size)).astype(np.float32)


def _cases():
    rng = np.random.default_rng(3)
    return {
        "7s": _speechlike(7.0, 1),
        "30s": _speechlike(30.0, 2),
        "silent": np.zeros(16000 * 12, np.float32),
        "full_scale": np.clip(rng.standard_normal(16000 * 30) * 0.9, -1, 1)
        .astype(np.float32),
    }


@pytest.mark.parametrize("name", ["7s", "30s", "silent", "full_scale"])
def test_log_mel_matches_jax(name):
    audio = tmel.pad_or_trim(_cases()[name])[None]
    want = np.asarray(jmel.log_mel_spectrogram(audio))
    got = tmel.log_mel_spectrogram(audio, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (1, 80, 3000)
    assert np.abs(got.numpy() - want).max() <= MEL_MAX_ABS


def test_log_mel_batch_rows_are_independent():
    """A window's features do not depend on the rows packed with it (the
    max - 8 clamp is per window)."""
    cases = _cases()
    batch = np.stack([tmel.pad_or_trim(cases[k]) for k in ("7s", "silent",
                                                           "full_scale")])
    packed = tmel.log_mel_spectrogram(batch, device="cpu")
    solo = tmel.log_mel_spectrogram(batch[:1], device="cpu")
    assert torch.equal(packed[:1], solo)
    assert np.abs(packed.numpy()
                  - np.asarray(jmel.log_mel_spectrogram(batch))).max() \
        <= MEL_MAX_ABS


def test_filter_bank_and_pad_or_trim_identical():
    for n_mels in (80, 128):
        assert np.array_equal(tmel.mel_filter_bank(n_mels),
                              jmel.mel_filter_bank(n_mels))
    x = np.arange(10, dtype=np.float32)
    for length in (4, 10, 16):
        assert np.array_equal(tmel.pad_or_trim(x, length),
                              jmel.pad_or_trim(x, length))
    assert (tmel.N_SAMPLES, tmel.N_FRAMES) == (jmel.N_SAMPLES, jmel.N_FRAMES)


def test_entry_point_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        tmel.log_mel_spectrogram(np.zeros((1, 16000), np.float32))
