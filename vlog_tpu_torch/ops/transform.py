"""H.264 4x4 integer transform and quantiser over batched int32 tensors.

Port of ``vlog_tpu/ops/transform.py``, bit-exact: every op is integer
arithmetic with arithmetic right shifts, as the spec's decoder does
(ITU-T H.264 8.5). The 4x4 products are written out as butterflies
instead of matmuls, because CUDA has no integer matmul and the integer
sums are exact in any order.

``qp`` is a Python int or an int32 tensor whose dims line up with the
LEADING dims of the coefficient tensor (one QP per frame: shape ``(n,)``
against coefficients ``(n, ...)``), so rate control varies QP per frame.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Forward core transform Cf (applied as Cf @ X @ Cf.T).
CF = np.array([[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]],
              dtype=np.int32)

# Quantisation multiplier MF per QP%6 for coefficient classes (a, b, c).
_MF_ABC = np.array([
    [13107, 5243, 8066],
    [11916, 4660, 7490],
    [10082, 4194, 6554],
    [9362, 3647, 5825],
    [8192, 3355, 5243],
    [7282, 2893, 4559],
], dtype=np.int32)

# Dequantisation scale V per QP%6 for (a, b, c).
_V_ABC = np.array([
    [10, 16, 13],
    [11, 18, 14],
    [13, 20, 16],
    [14, 23, 18],
    [16, 25, 20],
    [18, 29, 23],
], dtype=np.int32)

# Class index (0=a, 1=b, 2=c) per 4x4 position.
_CLASS = np.array([[0, 2, 0, 2], [2, 1, 2, 1], [0, 2, 0, 2], [2, 1, 2, 1]],
                  dtype=np.int32)

_TABLES = {
    "mf44": _MF_ABC[:, _CLASS],     # (6, 4, 4)
    "v44": _V_ABC[:, _CLASS],       # (6, 4, 4)
    "mf00": _MF_ABC[:, 0].copy(),   # (6,)
    "v00": _V_ABC[:, 0].copy(),     # (6,)
}


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_TABLES[name], device=device)


def _qp(qp, x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(qp, dtype=torch.int32, device=x.device)


def _lead(t: torch.Tensor, x: torch.Tensor, tail: int = 0) -> torch.Tensor:
    """View ``t`` (per-QP dims + ``tail`` trailing dims) so it broadcasts
    against ``x``: ones are inserted between the QP dims and the tail."""
    k = t.dim() - tail
    return t.reshape(tuple(t.shape[:k]) + (1,) * (x.dim() - k - tail)
                     + tuple(t.shape[k:]))


def _one_shl(s: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(s) << s


def _comb4(x: torch.Tensor, dim: int, rows) -> torch.Tensor:
    """out[i] = sum_j rows[i][j] * x[j] along ``dim`` (size 4)."""
    xs = x.unbind(dim)
    outs = []
    for coef in rows:
        acc = None
        for c, v in zip(coef, xs):
            if c == 0:
                continue
            term = v if c == 1 else (-v if c == -1 else c * v)
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.stack(outs, dim)


_H4 = ((1, 1, 1, 1), (1, 1, -1, -1), (1, -1, -1, 1), (1, -1, 1, -1))
_CF_ROWS = tuple(tuple(int(v) for v in r) for r in CF)


def core_transform(blocks: torch.Tensor) -> torch.Tensor:
    """Forward 4x4 core transform: Cf @ X @ Cf.T over (..., 4, 4) int32."""
    x = blocks.to(torch.int32)
    return _comb4(_comb4(x, -2, _CF_ROWS), -1, _CF_ROWS)


def quantize(coeffs: torch.Tensor, *, qp, intra: bool = True) -> torch.Tensor:
    """Z = sign(W) * ((|W| * MF + f) >> qbits), qbits = 15 + QP//6,
    f = 2^qbits/3 (intra) or /6 (inter)."""
    w = coeffs.to(torch.int32)
    q = _qp(qp, w)
    qbits = 15 + torch.div(q, 6, rounding_mode="floor")
    mf = _table("mf44", w.device)[q % 6]
    f = torch.div(_one_shl(qbits), 3 if intra else 6, rounding_mode="floor")
    mag = (w.abs() * _lead(mf, w, 2) + _lead(f, w)) >> _lead(qbits, w)
    return torch.sign(w) * mag


def dequantize(levels: torch.Tensor, *, qp) -> torch.Tensor:
    """W' = Z * V * 2^(QP//6) over (..., 4, 4)."""
    x = levels.to(torch.int32)
    q = _qp(qp, x)
    v = _table("v44", x.device)[q % 6]
    return (x * _lead(v, x, 2)) << _lead(torch.div(q, 6, rounding_mode="floor"), x)


def inverse_core_transform(coeffs: torch.Tensor) -> torch.Tensor:
    """Bit-exact inverse 4x4 transform (8.5.12.2) incl. final (x+32)>>6."""
    w = coeffs.to(torch.int32)

    def onepass(m):
        w0, w1, w2, w3 = m[..., 0], m[..., 1], m[..., 2], m[..., 3]
        e0 = w0 + w2
        e1 = w0 - w2
        e2 = (w1 >> 1) - w3
        e3 = w1 + (w3 >> 1)
        return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)

    h = onepass(w)
    v = onepass(h.transpose(-1, -2))
    return (v.transpose(-1, -2) + 32) >> 6


def hadamard4(blocks: torch.Tensor) -> torch.Tensor:
    """4x4 Hadamard (Intra_16x16 luma DC), H @ X @ H.T, no scaling."""
    x = blocks.to(torch.int32)
    return _comb4(_comb4(x, -2, _H4), -1, _H4)


def quantize_luma_dc(dc: torch.Tensor, *, qp) -> torch.Tensor:
    """Z = sign * ((|Y| * MF(0,0) + f2) >> (qbits+2)) (see the JAX
    reference for the derivation of the +2)."""
    w = dc.to(torch.int32)
    q = _qp(qp, w)
    qbits2 = 17 + torch.div(q, 6, rounding_mode="floor")
    mf00 = _table("mf00", w.device)[q % 6]
    f2 = torch.div(_one_shl(qbits2), 3, rounding_mode="floor")
    mag = (w.abs() * _lead(mf00, w) + _lead(f2, w)) >> _lead(qbits2, w)
    return torch.sign(w) * mag


def dequantize_luma_dc(levels: torch.Tensor, *, qp) -> torch.Tensor:
    """Inverse Hadamard + dequant for luma DC (spec 8.5.10)."""
    f = hadamard4(levels)
    q = _qp(qp, f)
    q6 = torch.div(q, 6, rounding_mode="floor")
    v00 = _lead(_table("v00", f.device)[q % 6], f)
    hi = (f * v00) << _lead(torch.clamp(q6 - 2, min=0), f)
    lo = (f * v00 + _lead(_one_shl(torch.clamp(1 - q6, min=0)), f)
          ) >> _lead(torch.clamp(2 - q6, min=0), f)
    return torch.where(_lead(q >= 12, f), hi, lo)


def hadamard2x2(dc: torch.Tensor) -> torch.Tensor:
    """2x2 Hadamard for chroma DC: H2 @ X @ H2."""
    x = dc.to(torch.int32)
    a, b = x[..., 0, 0], x[..., 0, 1]
    c, d = x[..., 1, 0], x[..., 1, 1]
    top = torch.stack([a + b + c + d, a - b + c - d], dim=-1)
    bot = torch.stack([a + b - c - d, a - b - c + d], dim=-1)
    return torch.stack([top, bot], dim=-2)


def quantize_chroma_dc(dc: torch.Tensor, *, qp) -> torch.Tensor:
    """Quantise 2x2 chroma DC (spec 8.5.11 encoder mirror)."""
    w = dc.to(torch.int32)
    q = _qp(qp, w)
    qbits = 15 + torch.div(q, 6, rounding_mode="floor")
    mf00 = _table("mf00", w.device)[q % 6]
    f = torch.div(_one_shl(qbits), 3, rounding_mode="floor")
    mag = (w.abs() * _lead(mf00, w) + _lead(2 * f, w)) >> _lead(qbits + 1, w)
    return torch.sign(w) * mag


def dequantize_chroma_dc(levels: torch.Tensor, *, qp) -> torch.Tensor:
    """Inverse 2x2 Hadamard + dequant for chroma DC (spec 8.5.11)."""
    f = hadamard2x2(levels)
    q = _qp(qp, f)
    v00 = _lead(_table("v00", f.device)[q % 6], f)
    return ((f * v00) << _lead(torch.div(q, 6, rounding_mode="floor"), f)) >> 1


def blocks_from_plane(plane: torch.Tensor, block: int = 4) -> torch.Tensor:
    """(..., H, W) -> (..., H//b, W//b, b, b) tiling."""
    *lead, h, w = plane.shape
    x = plane.reshape(*lead, h // block, block, w // block, block)
    return x.transpose(-3, -2)


def plane_from_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`blocks_from_plane`."""
    *lead, nh, nw, b, b2 = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, nh * b, nw * b2)
