"""HEVC core transform + quantization (H.265 8.6), numpy reference.

Matrix generation: every entry of the NxN integer DCT-like matrices is
one of the normative basis magnitudes at angle pi*t/64 — factor the
odd part of t and index the per-octave coefficient lists (the familiar
{83,36} / {89,75,50,18} / ... sets every HEVC text tabulates).  The
construction is validated structurally below (known 4/8-point rows
asserted at import) and end-to-end by the libavcodec oracle tests: a
wrong entry would break bit-exact reconstruction immediately.

Inverse transform and dequantization follow the spec exactly (they
must match every conforming decoder); the forward direction uses the
HM-style shifts, which is an encoder choice, not normative.
"""

from __future__ import annotations

import numpy as np

_C32 = [90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4]
_C16 = [90, 87, 80, 70, 57, 43, 25, 9]
_C8 = [89, 75, 50, 18]
_C4 = [83, 36]
_LISTS = [_C32, _C16, _C8, _C4, [64]]


def _entry(t: int) -> int:
    """Matrix value at angle pi*t/64 (t already reduced mod 128)."""
    sign = -1 if 32 < t < 96 else 1
    u = t % 64
    u = min(u, 64 - u)
    if u == 0:
        return sign * 64
    e = (u & -u).bit_length() - 1         # factor-of-2 exponent
    odd = u >> e
    return sign * _LISTS[e][(odd - 1) // 2]


def _matrix(n: int) -> np.ndarray:
    step = 32 // n                         # angle scale onto the /64 grid
    m = np.empty((n, n), dtype=np.int32)
    for r in range(n):
        for c in range(n):
            m[r, c] = _entry((step * r * (2 * c + 1)) % 128)
    return m

T32 = _matrix(32)
T16 = _matrix(16)
T8 = _matrix(8)          # chroma sub-TUs of forced-split inter CUs

# structural self-check against the universally known small transforms
assert T32[0].tolist() == [64] * 32
assert _matrix(4).tolist() == [[64, 64, 64, 64], [83, 36, -36, -83],
                               [64, -64, -64, 64], [36, -83, 83, -36]]
assert _matrix(8)[3].tolist() == [75, -18, -89, -50, 50, 89, 18, -75]

# level scales (H.265 8.6.3) and HM forward quant scales
LEVEL_SCALE = np.array([40, 45, 51, 57, 64, 72], dtype=np.int64)
QUANT_SCALE = np.array([26214, 23302, 20560, 18396, 16384, 14564],
                       dtype=np.int64)

# chroma QP mapping for 4:2:0 (H.265 table 8-10)
_QPC = list(range(30)) + [29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36,
                          36, 37]


def chroma_qp(qp_y: int) -> int:
    qpi = min(max(qp_y, 0), 51)
    return _QPC[qpi] if qpi < 43 else qpi - 6


def _mat_for(n: int) -> np.ndarray:
    if n == 32:
        return T32
    if n == 16:
        return T16
    return T8


def forward_transform(res: np.ndarray) -> np.ndarray:
    """HM-style two-stage forward DCT, 8-bit input residual (N, N)."""
    n = res.shape[-1]
    m = _mat_for(n).astype(np.int64)
    log2n = n.bit_length() - 1
    s1 = log2n - 1                       # log2N + bitDepth - 9
    s2 = log2n + 6
    tmp = (m @ res.astype(np.int64) + (1 << (s1 - 1))) >> s1
    return ((tmp @ m.T + (1 << (s2 - 1))) >> s2).astype(np.int32)


def inverse_transform(coeff: np.ndarray, bit_depth: int = 8) -> np.ndarray:
    """Spec-exact inverse (8.6.4): column pass, clip to 16 bit, row pass."""
    n = coeff.shape[-1]
    m = _mat_for(n).astype(np.int64)
    e = (m.T @ coeff.astype(np.int64) + 64) >> 7   # vertical pass
    e = np.clip(e, -32768, 32767)
    s2 = 20 - bit_depth
    r = (e @ m + (1 << (s2 - 1))) >> s2            # horizontal pass
    return np.clip(r, -32768, 32767).astype(np.int32)


def quantize(coeff: np.ndarray, qp: int) -> np.ndarray:
    """HM-style forward quant with intra rounding offset (1/3)."""
    n = coeff.shape[-1]
    log2n = n.bit_length() - 1
    tr_shift = 15 - 8 - log2n
    qbits = 14 + qp // 6 + tr_shift
    f = QUANT_SCALE[qp % 6]
    offset = (1 << qbits) * 171 >> 9     # ~1/3, intra
    level = (np.abs(coeff.astype(np.int64)) * f + offset) >> qbits
    level = np.clip(level, 0, 32767)
    return (np.sign(coeff) * level).astype(np.int32)


def dequantize(level: np.ndarray, qp: int, bit_depth: int = 8) -> np.ndarray:
    """Spec 8.6.3 with flat (m=16) scaling."""
    n = level.shape[-1]
    log2n = n.bit_length() - 1
    bd_shift = bit_depth + log2n - 5
    scale = (LEVEL_SCALE[qp % 6] << (qp // 6)) * 16
    d = (level.astype(np.int64) * scale + (1 << (bd_shift - 1))) >> bd_shift
    return np.clip(d, -32768, 32767).astype(np.int32)
