"""Whisper log-mel frontend in PyTorch on an explicit device.

The operations of ``vlog_tpu/asr/mel.py`` in the same order: reflect
pad, 400-sample frames at hop 160 times a periodic Hann window, ``rfft``,
``abs(spec) ** 2`` with the trailing frame dropped, the slaney mel
projection as one matmul, ``log10(max(., 1e-10))``, the per-window
max - 8 clamp, then ``(x + 4) / 4``. The filter bank is the same numpy
float64 construction cast to float32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16_000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH_S = 30
N_SAMPLES = SAMPLE_RATE * CHUNK_LENGTH_S      # 480_000
N_FRAMES = N_SAMPLES // HOP_LENGTH            # 3000


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale: linear below 1 kHz, log above."""
    f = np.asarray(f, np.float64)
    mel = 3.0 * f / 200.0
    log_region = f >= 1000.0
    mel = np.where(
        log_region,
        15.0 + 27.0 * np.log(np.maximum(f, 1e-10) / 1000.0) / np.log(6.4),
        mel,
    )
    return mel


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f = 200.0 * m / 3.0
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp(np.log(6.4) * (m - 15.0) / 27.0), f)
    return f


@lru_cache(maxsize=4)
def mel_filter_bank(n_mels: int = 80, n_fft: int = N_FFT,
                    sample_rate: int = SAMPLE_RATE,
                    fmax: float | None = None) -> np.ndarray:
    """(n_freq, n_mels) triangular slaney-normalized filterbank."""
    fmax = fmax if fmax is not None else sample_rate / 2.0
    n_freq = n_fft // 2 + 1
    freqs = np.linspace(0.0, sample_rate / 2.0, n_freq)
    mel_pts = np.linspace(_hz_to_mel_slaney(np.array(0.0)),
                          _hz_to_mel_slaney(np.array(fmax)), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fb = np.zeros((n_freq, n_mels), np.float64)
    for i in range(n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - freqs) / max(hi - ctr, 1e-10)
        fb[:, i] = np.maximum(0.0, np.minimum(up, down))
        fb[:, i] *= 2.0 / (hi - lo)           # slaney area normalization
    return fb.astype(np.float32)


@torch.inference_mode()
def log_mel_spectrogram(audio, *, n_mels: int = 80,
                        device: str | torch.device = "cuda") -> torch.Tensor:
    """(B, N_SAMPLES) float PCM in [-1, 1] (numpy or tensor) ->
    (B, n_mels, N_FRAMES) float32 features on ``device``."""
    from vlog_tpu_torch.device import resolve_device

    x = torch.as_tensor(audio, device=resolve_device(device)).to(torch.float32)
    if x.ndim == 1:
        x = x[None]
    n = x.shape[1]
    window = torch.as_tensor(np.hanning(N_FFT + 1)[:-1].astype(np.float32),
                             device=x.device)
    pad = N_FFT // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0]
    n_frames_total = 1 + n // HOP_LENGTH      # 3001 for a full 30 s chunk
    frames = x.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames_total] * window
    spec = torch.fft.rfft(frames, dim=-1)
    power = spec[:, :-1, :].abs() ** 2        # drop the trailing frame
    fb = torch.as_tensor(mel_filter_bank(n_mels), device=x.device)
    mel = power @ fb                          # (B, F-1, n_mels)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    cap = torch.amax(log_spec, dim=(1, 2), keepdim=True) - 8.0
    log_spec = torch.maximum(log_spec, cap)
    log_spec = (log_spec + 4.0) / 4.0
    return log_spec.transpose(1, 2).contiguous()   # (B, n_mels, frames)


def pad_or_trim(audio: np.ndarray, length: int = N_SAMPLES) -> np.ndarray:
    """Whisper windows are exactly 30 s; zero-pad or cut the tail."""
    if audio.shape[-1] >= length:
        return audio[..., :length]
    pad = [(0, 0)] * (audio.ndim - 1) + [(0, length - audio.shape[-1])]
    return np.pad(audio, pad)
