"""Voice-activity detection: which stretches of audio carry speech.

A copy of ``vlog_tpu/asr/vad.py`` (host-side, numpy).

The reference filters silence through faster-whisper's Silero-based
``vad_filter`` (worker/transcription.py:92-133) so the model never
decodes dead air. This is the first-party analog: a frame-level
detector on three cheap spectral features with an adaptive noise floor
and hangover smoothing — not a neural VAD, but it makes the same
decisions on the same material (silence, hum, and broadband noise drop;
modulated/harmonic content survives):

- **log energy vs an adaptive floor**: the 10th-percentile frame energy
  tracks the noise bed; speech must clear it by a margin.
- **spectral flatness**: broadband noise is flat (geometric mean close
  to arithmetic mean); voiced speech is peaky. High-energy flat frames
  (fan/hiss ramps) stay rejected.
- **low-band dominance**: speech energy concentrates under ~1 kHz
  relative to the 4-8 kHz band; hiss and clicks do not.

Frames: 25 ms window / 10 ms hop at 16 kHz. Decisions are median-
filtered and dilated by a hangover so word-internal dips and onsets
survive (the reason raw energy gates clip leading consonants).
"""

from __future__ import annotations

import numpy as np

SR = 16_000
FRAME_S = 0.025
HOP_S = 0.010
# decision smoothing: median window and hangover padding (seconds)
MEDIAN_S = 0.07
HANGOVER_S = 0.20
ENERGY_MARGIN_DB = 6.0        # above the adaptive noise floor
ABS_SILENCE_DB = -55.0        # below this, never speech (dBFS RMS)
ABS_SPEECH_DB = -35.0         # above this, loud enough regardless of the
#                               floor (an all-speech clip raises its own
#                               "noise" percentile to speech level)
FLATNESS_MAX = 0.5            # geometric/arithmetic spectral mean


def _frame(x: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = 1 + max(0, (len(x) - frame)) // hop
    idx = np.arange(frame)[None, :] + hop * np.arange(n)[:, None]
    return x[np.minimum(idx, len(x) - 1)]


def speech_mask(samples: np.ndarray, sr: int = SR) -> np.ndarray:
    """Per-hop boolean speech decisions for 16 kHz mono float PCM.

    Features are computed in bounded chunks of frames: a 2-hour clip is
    ~720k frames, and framing + FFTing it in one shot would materialize
    multi-GB temporaries; the per-frame feature vectors themselves are
    tiny and concatenate exactly (frames are independent given samples).
    """
    x = np.asarray(samples, np.float32)
    if x.size == 0:
        return np.zeros(0, bool)
    frame = int(round(FRAME_S * sr))
    hop = int(round(HOP_S * sr))
    window = np.hanning(frame)[None, :]
    freqs = np.fft.rfftfreq(frame, 1.0 / sr)
    n_frames = 1 + max(0, (len(x) - frame)) // hop
    chunk = 16_384                           # frames per feature block

    db_l, flat_l, low_l, high_l = [], [], [], []
    for f0 in range(0, n_frames, chunk):
        f1 = min(f0 + chunk, n_frames)
        seg = x[f0 * hop:(f1 - 1) * hop + frame]
        frames_c = _frame(seg, frame, hop)[:f1 - f0] * window
        spec = np.abs(np.fft.rfft(frames_c, axis=1)) ** 2
        energy = spec.sum(axis=1) + 1e-12
        db_l.append(10.0 * np.log10(energy / frame))
        flat_l.append(np.exp(np.mean(np.log(spec + 1e-12), axis=1))
                      / (np.mean(spec, axis=1) + 1e-12))
        low_l.append(spec[:, (freqs >= 80) & (freqs < 1000)].sum(axis=1))
        high_l.append(spec[:, (freqs >= 4000) & (freqs < 8000)].sum(axis=1))
    db = np.concatenate(db_l)
    flatness = np.concatenate(flat_l)
    low = np.concatenate(low_l)
    high = np.concatenate(high_l)

    # adaptive floor: the quiet percentile of the clip's frames; loud
    # frames pass outright (a wall-to-wall speech clip's floor IS speech)
    floor_db = np.percentile(db, 10.0)
    energetic = (((db > floor_db + ENERGY_MARGIN_DB)
                  | (db > ABS_SPEECH_DB))
                 & (db > ABS_SILENCE_DB))

    peaky = flatness < FLATNESS_MAX
    voiced_band = low > 1.5 * high

    raw = energetic & (peaky | voiced_band)

    # median smoothing (boolean median == majority count over window)
    k = max(1, int(round(MEDIAN_S / HOP_S)) | 1)
    sm = np.convolve(raw.astype(np.int16), np.ones(k, np.int16),
                     "same") > k // 2

    # hangover dilation: speech extends ±HANGOVER_S
    h = int(round(HANGOVER_S / HOP_S))
    if h:
        sm = np.convolve(sm.astype(np.int16),
                         np.ones(2 * h + 1, np.int16), "same") > 0
    return sm


def speech_spans(samples: np.ndarray, sr: int = SR
                 ) -> list[tuple[float, float]]:
    """Merged (start_s, end_s) speech regions."""
    mask = speech_mask(samples, sr)
    if not mask.any():
        return []
    spans = []
    start = None
    for i, m in enumerate(mask):
        if m and start is None:
            start = i
        elif not m and start is not None:
            spans.append((start * HOP_S, i * HOP_S))
            start = None
    if start is not None:
        spans.append((start * HOP_S, len(mask) * HOP_S))
    return spans


def window_has_speech(spans: list[tuple[float, float]], t0: float,
                      t1: float) -> bool:
    return any(s < t1 and e > t0 for s, e in spans)
