"""MDCT / IMDCT and the AAC window shapes (ISO/IEC 14496-3 4.6.11; port of
``vlog_tpu/codecs/aac/mdct.py``).

The forward MDCT is a dense (N/2, N) cosine-basis matmul on the device:
for 48 kHz stereo a 30 s chunk is a (2, 1408, 2048) x (2048, 1024)
float32 product, as the reference's XLA einsum computes it. The
decoder's IMDCT and the windows stay host-side numpy.

Conventions: forward X[k] = 2 sum_n z[n] cos(2pi/N (n+n0)(k+1/2)),
inverse x[n] = (2/N) sum_k X[k] cos(...), n0 = (N/2+1)/2 (the spec's
scaling). Sine and KBD windows per 4.6.11.3; with overlap-add the pair
is unity-gain (Princen-Bradley TDAC).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vlog_tpu_torch.device import strict_fp32

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


def forward_mdct(frames: torch.Tensor,
                 basis: torch.Tensor | None = None) -> torch.Tensor:
    """(..., N) windowed time blocks -> (..., N/2) coefficients, float32
    on the frames' device (TF32 off), as the reference's
    ``forward_mdct(use_jax=True)`` computes them.

    The caller applies the window first; ``basis`` is ``mdct_matrix(N)``
    as float32 on the frames' device (built here when not given).
    """
    strict_fp32()
    if basis is None:
        basis = torch.as_tensor(mdct_matrix(frames.shape[-1]),
                                dtype=torch.float32, device=frames.device)
    return 2.0 * torch.einsum("kn,...n->...k", basis,
                              frames.to(torch.float32))


def inverse_mdct(coeffs: np.ndarray) -> np.ndarray:
    """(..., N/2) coefficients -> (..., N) time aliased blocks (2/N scale)."""
    half = coeffs.shape[-1]
    n = half * 2
    m = mdct_matrix(n)
    return (2.0 / n) * (coeffs.astype(np.float64) @ m)
