"""The inverse MDCT and the AAC window shapes the host decoder needs
(ISO/IEC 14496-3 4.6.11; the numpy half of ``vlog_tpu/codecs/aac/mdct.py``).

Conventions: inverse x[n] = (2/N) sum_k X[k] cos(2pi/N (n+n0)(k+1/2)),
n0 = (N/2+1)/2 (the spec's scaling). Sine and KBD windows per
4.6.11.3; with overlap-add the pair is unity-gain (Princen-Bradley TDAC).
"""

from __future__ import annotations

import functools

import numpy as np

LONG_N = 2048
SHORT_N = 256

ONLY_LONG_SEQUENCE = 0
LONG_START_SEQUENCE = 1
EIGHT_SHORT_SEQUENCE = 2
LONG_STOP_SEQUENCE = 3


@functools.lru_cache(maxsize=8)
def mdct_matrix(n: int) -> np.ndarray:
    """(N/2, N) cosine basis."""
    n0 = (n // 2 + 1) / 2.0
    k = np.arange(n // 2, dtype=np.float64)[:, None]
    t = np.arange(n, dtype=np.float64)[None, :]
    return np.cos(2.0 * np.pi / n * (t + n0) * (k + 0.5))


@functools.lru_cache(maxsize=8)
def sine_window(n: int) -> np.ndarray:
    """sin(pi/N (n + 1/2)), full length N (4.6.11.3.2)."""
    i = np.arange(n, dtype=np.float64)
    return np.sin(np.pi / n * (i + 0.5))


@functools.lru_cache(maxsize=8)
def kbd_window(n: int, alpha: float | None = None) -> np.ndarray:
    """Kaiser-Bessel-derived window (4.6.11.3.3): alpha=4 long, 6 short."""
    if alpha is None:
        alpha = 4.0 if n >= LONG_N else 6.0
    half = n // 2
    from numpy import i0

    t = np.arange(half + 1, dtype=np.float64)
    kaiser = i0(np.pi * alpha * np.sqrt(1.0 - (2.0 * t / half - 1.0) ** 2))
    cum = np.cumsum(kaiser)
    w_half = np.sqrt(cum[:half] / cum[half])
    return np.concatenate([w_half, w_half[::-1]])


def window_halves(shape: int, n: int) -> tuple[np.ndarray, np.ndarray]:
    """(rising, falling) halves for window_shape 0=sine, 1=KBD."""
    w = kbd_window(n) if shape else sine_window(n)
    return w[: n // 2], w[n // 2:]


def inverse_mdct(coeffs: np.ndarray) -> np.ndarray:
    """(..., N/2) coefficients -> (..., N) time aliased blocks (2/N scale)."""
    half = coeffs.shape[-1]
    n = half * 2
    m = mdct_matrix(n)
    return (2.0 / n) * (coeffs.astype(np.float64) @ m)
