"""The plain H.264 chain DSP on PyTorch tensors: a frozen copy of the
port's plain H.264 stages (``ops/transform.py``, ``codecs/h264/
encoder.py``, ``codecs/h264/inter.py``, ``ops/bitproxy.py`` and the chain
step ``parallel/ladder.py::_one_rung`` after the resize), the reference
the ``h264-ladder`` cell replays sampled chains on. It imports nothing
of the port and no JAX: plain ``torch`` and ``numpy``, integer
arithmetic throughout (only the bit proxy's log2 sums are float32).

What it follows in ITU-T H.264, and where it follows the port's
documented decisions instead (an encoder's choices the standard leaves
open):

- **Intra (8.3.3, 8.3.4).** Every macroblock of an I picture is
  Intra_16x16 with the port's restricted mode set: macroblock row 0
  predicts DC from its left neighbour only (128 for the first
  macroblock), chroma DC likewise (8.3.4.1-2: each 4x4 chroma quadrant
  from the left column's rows); every later row predicts Vertical from
  the row above, luma and chroma. Row 0 is a loop over macroblock
  columns, each later row one batched step.
- **Transform and quantisation (8.5).** The 4x4 core transform, the
  Intra_16x16 luma DC Hadamard and the 2x2 chroma DC transform, with
  the decoder's scaling (8.5.9-8.5.12: ``LevelScale`` from the spec's
  v table, the ``(x + 32) >> 6`` inverse). The forward quantiser is an
  encoder's choice: the port's dead zone (offset 2^qbits/3 intra, /6
  inter) and its DC shifts.
- **Inter (8.4).** Every macroblock of a P picture is P_L0_16x16 with
  one reference, the previous picture's filtered reconstruction (skip
  is decided at entropy time, outside the DSP). Luma samples at
  quarter-sample MVs by the six-tap half-sample filter and the
  averaging of 8.4.2.2.1; chroma at eighth-sample positions by the
  bilinear blend of 8.4.2.2.2; reference samples outside the picture
  are the edge's (8.4.2.2's clamped coordinates, as replicate
  padding). The search is the port's: full integer search over +-search
  with cost SAD + 4 x lambda x |offset| (lambda 4), (0, 0) first and
  then raster order, the first minimum winning; then half- and
  quarter-sample refinement over the 8 neighbours in order, the seed
  kept on ties, cost SAD + lambda x |MV|. Inter luma is 16 coefficients
  a 4x4 block with the port's macroblock decimation (scattered +-1s
  whose weighted score is under 6 are zeroed); chroma has the DC
  transform.
- **The chain and its rate cascade (the port's ``_one_rung``).** The
  rung's frames are edge-padded to whole macroblocks; the I frame, then
  each P frame against the filtered reconstruction before it, the
  in-loop filter (``h264_deblock``) after each when ``deblock``. With
  ``rc``, each chain carries a float32 byte balance: a P frame's QP is
  its plan QP moved by trunc(balance / (3 x budget)) in [-1, +8],
  clipped to 10-51; after it the balance adds cost x alpha - budget
  (nothing while alpha is 0), floored at -3 and capped at 30 budgets;
  the cost is the bit proxy (nonzero levels + sum of log2(1 + |level|)).
  The I frame's cost counts, its balance does not.

Departures from the port: only the layout. ``encode_chain`` takes the
rate-control scalars as anything that broadcasts to one value a chain,
so chains of several jobs replay in one batch, and returns every
frame's filtered reconstruction (the port keeps them on the device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from benchmark.reference.h264_deblock import (chroma_qp, deblock_frame,
                                              intra_bs, p_bs)

# --- 8.5: the 4x4 integer transform and the quantiser -----------------------

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


# --- 8.3.3, 8.3.4: Intra_16x16 and chroma intra (the port's mode set) -------

def _zero_dc(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[..., 0, 0] = 0
    return x


def _set_dc(x: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[..., 0, 0] = dc
    return x


def _luma_encode(y_row, pred, qp):
    """One MB row of luma for every frame. y_row/pred (n, 16, W) int32.

    Returns (dc (n, mbw, 4, 4), ac (n, mbw, 4, 4, 4, 4), recon (n, 16, W)).
    """
    n, _, w = y_row.shape
    mbw = w // 16
    resid = y_row - pred
    mb = resid.reshape(n, 16, mbw, 16).transpose(1, 2)           # (n,mbw,16,16)
    blocks = mb.reshape(n, mbw, 4, 4, 4, 4).transpose(3, 4)
    coefs = core_transform(blocks)
    dc_levels = quantize_luma_dc(hadamard4(coefs[..., 0, 0]), qp=qp)
    ac_levels = _zero_dc(quantize(coefs, qp=qp, intra=True))
    full = _set_dc(dequantize(ac_levels, qp=qp),
                   dequantize_luma_dc(dc_levels, qp=qp))
    resid_rec = inverse_core_transform(full)
    mb_rec = resid_rec.transpose(3, 4).reshape(n, mbw, 16, 16)
    row_rec = mb_rec.transpose(1, 2).reshape(n, 16, w)
    return dc_levels, ac_levels, torch.clamp(pred + row_rec, 0, 255)


def _chroma_encode(c_row, pred, qpc):
    """One MB row of one chroma plane. c_row/pred (n, 8, Wc) int32."""
    n, _, wc = c_row.shape
    mbw = wc // 8
    resid = c_row - pred
    mb = resid.reshape(n, 8, mbw, 8).transpose(1, 2)              # (n,mbw,8,8)
    blocks = mb.reshape(n, mbw, 2, 4, 2, 4).transpose(3, 4)       # (n,mbw,2,2,4,4)
    coefs = core_transform(blocks)
    dc_levels = quantize_chroma_dc(hadamard2x2(coefs[..., 0, 0]), qp=qpc)
    ac_levels = _zero_dc(quantize(coefs, qp=qpc, intra=True))
    full = _set_dc(dequantize(ac_levels, qp=qpc),
                   dequantize_chroma_dc(dc_levels, qp=qpc))
    resid_rec = inverse_core_transform(full)
    mb_rec = resid_rec.transpose(3, 4).reshape(n, mbw, 8, 8)
    row_rec = mb_rec.transpose(1, 2).reshape(n, 8, wc)
    return dc_levels, ac_levels, torch.clamp(pred + row_rec, 0, 255)


def _chroma_dc_pred(left_col: torch.Tensor) -> torch.Tensor:
    """Chroma DC prediction with only the left MB (8.3.4.2): the top
    quadrants use left rows 0..3, the bottom ones rows 4..7. (n, 8)."""
    top = (left_col[:, :4].sum(1, dtype=torch.int32) + 2) >> 2
    bot = (left_col[:, 4:].sum(1, dtype=torch.int32) + 2) >> 2
    col = torch.cat([top[:, None].expand(-1, 4), bot[:, None].expand(-1, 4)], 1)
    return col[:, :, None].expand(-1, 8, 8)


def _encode_row0(y_row, u_row, v_row, qp, qpc):
    """MB row 0, a loop over MB columns (DC prediction from the left)."""
    n, _, w = y_row.shape
    mbw = w // 16
    ydc, yac, udc, uac, vdc, vac = [], [], [], [], [], []
    yrec, urec, vrec = [], [], []
    for c in range(mbw):
        y_mb = y_row[:, :, 16 * c:16 * c + 16]
        u_mb = u_row[:, :, 8 * c:8 * c + 8]
        v_mb = v_row[:, :, 8 * c:8 * c + 8]
        if c == 0:
            pred_y = torch.full_like(y_mb, 128)
            pred_u = torch.full_like(u_mb, 128)
            pred_v = torch.full_like(v_mb, 128)
        else:
            ly = yrec[-1][:, :, -1]
            dc = (ly.sum(1, dtype=torch.int32) + 8) >> 4
            pred_y = dc[:, None, None].expand(-1, 16, 16)
            pred_u = _chroma_dc_pred(urec[-1][:, :, -1])
            pred_v = _chroma_dc_pred(vrec[-1][:, :, -1])
        a, b, r = _luma_encode(y_mb, pred_y, qp)
        ydc.append(a[:, 0]), yac.append(b[:, 0]), yrec.append(r)
        a, b, r = _chroma_encode(u_mb, pred_u, qpc)
        udc.append(a[:, 0]), uac.append(b[:, 0]), urec.append(r)
        a, b, r = _chroma_encode(v_mb, pred_v, qpc)
        vdc.append(a[:, 0]), vac.append(b[:, 0]), vrec.append(r)
    st = lambda xs: torch.stack(xs, 1)                             # noqa: E731
    return (st(ydc), st(yac), st(udc), st(uac), st(vdc), st(vac),
            torch.cat(yrec, 2), torch.cat(urec, 2), torch.cat(vrec, 2))


def encode_frame(y, u, v, *, qp):
    """Encode a batch of 4:2:0 frames to levels + reconstruction.

    y (n, H, W), u/v (n, H/2, W/2) integer tensors, H and W multiples of
    16. ``qp``: int or (n,) int32 tensor. Returns the JAX function's dict
    with a leading ``n`` on every array (its ``vmap`` output layout).
    """
    n, h, w = y.shape
    mbh = h // 16
    if not isinstance(qp, torch.Tensor):
        qp = torch.full((n,), int(qp), dtype=torch.int32, device=y.device)
    qp = qp.to(device=y.device, dtype=torch.int32)
    qpc = chroma_qp(qp).to(torch.int32)
    y32, u32, v32 = y.to(torch.int32), u.to(torch.int32), v.to(torch.int32)

    r0 = _encode_row0(y32[:, :16], u32[:, :8], v32[:, :8], qp, qpc)
    ydc, yac, udc, uac, vdc, vac = ([t] for t in r0[:6])
    yrec, urec, vrec = [r0[6]], [r0[7]], [r0[8]]
    for r in range(1, mbh):
        pred_y = yrec[-1][:, -1:, :].expand(-1, 16, -1)
        pred_u = urec[-1][:, -1:, :].expand(-1, 8, -1)
        pred_v = vrec[-1][:, -1:, :].expand(-1, 8, -1)
        a, b, rec = _luma_encode(y32[:, 16 * r:16 * r + 16], pred_y, qp)
        ydc.append(a), yac.append(b), yrec.append(rec)
        a, b, rec = _chroma_encode(u32[:, 8 * r:8 * r + 8], pred_u, qpc)
        udc.append(a), uac.append(b), urec.append(rec)
        a, b, rec = _chroma_encode(v32[:, 8 * r:8 * r + 8], pred_v, qpc)
        vdc.append(a), vac.append(b), vrec.append(rec)
    st = lambda xs: torch.stack(xs, 1)                             # noqa: E731
    return {
        "luma_dc": st(ydc),                                       # (n,mbh,mbw,4,4)
        "luma_ac": st(yac),                                       # (n,mbh,mbw,4,4,4,4)
        "chroma_dc": torch.stack([st(udc), st(vdc)], 1),          # (n,2,mbh,mbw,2,2)
        "chroma_ac": torch.stack([st(uac), st(vac)], 1),          # (n,2,mbh,mbw,2,2,4,4)
        "recon_y": torch.cat(yrec, 1).to(torch.uint8),
        "recon_u": torch.cat(urec, 1).to(torch.uint8),
        "recon_v": torch.cat(vrec, 1).to(torch.uint8),
    }


# --- 8.4: P macroblocks (search, interpolation, inter residuals) -------------

# SAD penalty per quarter-pel of |MV| component (the MVD rate stand-in).
MV_COST_LAMBDA = 4

_SIX_TAP = (1, -5, 20, 20, -5, 1)

# Quarter-sample derivation (spec 8.4.2.2.1): each quarter position is the
# upward-rounded average of two samples from {G, b, h, j} at offsets 0/+1.
# Sample ids: 0=G(0,0) 1=G(0,+1) 2=G(+1,0) 3=b(0,0) 4=b(+1,0) 5=h(0,0)
# 6=h(0,+1) 7=j(0,0). Indexed [fy][fx].
_QPEL_A = np.array([[0, 0, 3, 3], [0, 3, 3, 3], [5, 5, 7, 7], [5, 5, 7, 6]],
                   np.int64)
_QPEL_B = np.array([[0, 3, 3, 1], [5, 5, 7, 6], [5, 7, 7, 6], [2, 4, 4, 4]],
                   np.int64)

# Zigzag scan of a 4x4 block (spec 8.5.6), for the decimation weights.
ZIGZAG_4x4 = [
    (0, 0), (0, 1), (1, 0), (2, 0), (1, 1), (0, 2), (0, 3), (1, 2),
    (2, 1), (3, 0), (3, 1), (2, 2), (1, 3), (2, 3), (3, 2), (3, 3),
]

# MB decimation (x264's dct_decimate idea): a macroblock whose quantized
# luma is only scattered +-1s is zeroed when their weighted score is below
# the threshold; any |level| >= 2 vetoes.
_DECIMATE_W = np.zeros((4, 4), np.int32)
for _zi, (_r, _c) in enumerate(ZIGZAG_4x4):
    _DECIMATE_W[_r, _c] = 3 if _zi <= 2 else (2 if _zi <= 9 else 1)
_DECIMATE_THRESHOLD = 6


def edge_pad(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Replicate-pad the last two dims by clamped indexing (works for
    every integer dtype on every backend)."""
    h, w = x.shape[-2], x.shape[-1]
    dev = x.device
    if top or bottom:
        rows = torch.clamp(torch.arange(-top, h + bottom, device=dev), 0, h - 1)
        x = x.index_select(-2, rows)
    if left or right:
        cols = torch.clamp(torch.arange(-left, w + right, device=dev), 0, w - 1)
        x = x.index_select(-1, cols)
    return x


def _six_tap_shift(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Un-normalized 6-tap at half positions: out[i] sits between i and
    i+1 (taps i-2..i+3). The roll's wrap reaches 3 (6 after the second
    pass) samples into the pad ring; the pad keeps gathers clear of it."""
    out = None
    for k, t in enumerate(_SIX_TAP):
        term = t * torch.roll(x, 2 - k, dims=dim)
        out = term if out is None else out + term
    return out


def half_pel_planes(refp: torch.Tensor):
    """Edge-padded (n, Hp, Wp) int32 reference -> (b, h, j) planes."""
    b1 = _six_tap_shift(refp, -1)
    h1 = _six_tap_shift(refp, -2)
    j1 = _six_tap_shift(b1, -2)
    b = torch.clamp((b1 + 16) >> 5, 0, 255)
    h = torch.clamp((h1 + 16) >> 5, 0, 255)
    j = torch.clamp((j1 + 512) >> 10, 0, 255)
    return b, h, j


def _mv_maps(mv: torch.Tensor, mb: int):
    """(n, mbh, mbw, 2) -> per-pixel (n, H, W) dy/dx maps."""
    rep = lambda t: t.repeat_interleave(mb, 1).repeat_interleave(mb, 2)  # noqa: E731
    return rep(mv[..., 0]), rep(mv[..., 1])


def _take(plane: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor):
    """plane (n, Hp, Wp)[b, rows, cols] for per-frame (n, H, W) indices."""
    n, _, wp = plane.shape
    idx = (rows * wp + cols).reshape(n, -1)
    return torch.gather(plane.reshape(n, -1), 1, idx).reshape(rows.shape)


def _gather_qpel(refp, planes, mv_q, *, pad: int, mb: int = 16):
    """Luma prediction at quarter-pel MVs: eight gathers, then one
    per-pixel pair select + average."""
    bpl, hpl, jpl = planes
    hp = refp.shape[1] - 2 * pad
    wp = refp.shape[2] - 2 * pad
    dy, dx = _mv_maps(mv_q, mb)
    iy, fy = dy >> 2, dy & 3
    ix, fx = dx >> 2, dx & 3
    dev = refp.device
    rows = (torch.arange(hp, device=dev)[:, None] + iy + pad).long()
    cols = (torch.arange(wp, device=dev)[None, :] + ix + pad).long()
    cand = torch.stack([
        _take(refp, rows, cols), _take(refp, rows, cols + 1),
        _take(refp, rows + 1, cols),
        _take(bpl, rows, cols), _take(bpl, rows + 1, cols),
        _take(hpl, rows, cols), _take(hpl, rows, cols + 1),
        _take(jpl, rows, cols),
    ])                                                  # (8, n, H, W)
    case = (fy * 4 + fx).long()
    ia = torch.as_tensor(_QPEL_A.reshape(-1), device=dev)[case]
    ib = torch.as_tensor(_QPEL_B.reshape(-1), device=dev)[case]
    pa = torch.gather(cand, 0, ia[None])[0]
    pb = torch.gather(cand, 0, ib[None])[0]
    return (pa + pb + 1) >> 1


def _block_sum(d: torch.Tensor, mb: int = 16) -> torch.Tensor:
    """(..., H, W) -> (..., H/mb, W/mb) per-MB sums (int64)."""
    *lead, h, w = d.shape
    return d.reshape(*lead, h // mb, mb, w // mb, mb).sum((-3, -1))


def motion_search(cur_y, ref_y, *, search: int = 8,
                  lam: int = MV_COST_LAMBDA, refp=None, planes=None):
    """Full-search integer ME + half- then quarter-pel refinement:
    (n, H, W) planes -> (n, mbh, mbw, 2) quarter-pel MVs (y, x)."""
    n, h, w = cur_y.shape
    cur = cur_y.to(torch.int32)
    pad = search + 8
    if refp is None:
        refp = edge_pad(ref_y.to(torch.int32), pad, pad, pad, pad)
    dev = cur.device

    # Costs in the reference's scan order: (0,0) first, then raster order
    # without (0,0). argmin keeps the first minimum = the strict-< scan.
    span = 2 * search + 1
    costs = []
    zero = None
    dxs = torch.arange(-search, search + 1, device=dev)
    for dy in range(-search, search + 1):
        x0 = pad - search
        strip = refp[:, pad + dy:pad + dy + h, x0:x0 + w + span - 1]
        win = strip.unfold(-1, w, 1)                     # (n, h, span, w)
        d = (cur[:, :, None, :] - win).abs().transpose(1, 2)  # (n,span,h,w)
        sad = _block_sum(d)                              # (n, span, mbh, mbw)
        cost = sad + (lam * 4 * (abs(dy) + dxs.abs()))[None, :, None, None]
        if dy == 0:
            zero = cost[:, search]
            cost = torch.cat([cost[:, :search], cost[:, search + 1:]], 1)
        costs.append(cost)
    all_cost = torch.cat([zero[:, None]] + costs, 1)     # (n, n_off, mbh, mbw)
    best = torch.argmin(all_cost, dim=1)                 # first minimum
    int_sad = torch.gather(all_cost, 1, best[:, None])[:, 0]
    offsets = [(0, 0)] + [(a, b) for a in range(-search, search + 1)
                          for b in range(-search, search + 1) if (a, b) != (0, 0)]
    offs = torch.as_tensor(offsets, dtype=torch.int32, device=dev)
    mv_int = offs[best]                                  # (n, mbh, mbw, 2)

    if planes is None:
        planes = half_pel_planes(refp)
    neigh = [(a, b) for a in (-1, 0, 1) for b in (-1, 0, 1) if (a, b) != (0, 0)]

    def refine(base_q, base_sad, step_q):
        cands = [base_q]
        sads = [base_sad]
        for a, b in neigh:
            off = torch.tensor([a, b], dtype=torch.int32, device=dev)
            cand = base_q + step_q * off
            pred = _gather_qpel(refp, planes, cand, pad=pad)
            sad = _block_sum((cur - pred).abs())
            sads.append(sad + lam * (cand[..., 0].abs() + cand[..., 1].abs()))
            cands.append(cand)
        pick = torch.argmin(torch.stack(sads, 1), dim=1)  # seed wins ties
        mv = torch.gather(torch.stack(cands, 1), 1,
                          pick[:, None, :, :, None].expand(-1, 1, -1, -1, 2))[:, 0]
        sad = torch.gather(torch.stack(sads, 1), 1, pick[:, None])[:, 0]
        return mv, sad

    mv_q, sad_q = refine(mv_int * 4, int_sad, 2)       # half-pel stage
    mv_q, _ = refine(mv_q, sad_q, 1)                   # quarter-pel stage
    return mv_q


def mc_luma(ref_y, mv_q, *, search: int, planes=None, refp=None):
    """Luma prediction at quarter-pel MVs (spec 8.4.2.2)."""
    pad = search + 8
    if refp is None:
        refp = edge_pad(ref_y.to(torch.int32), pad, pad, pad, pad)
    if planes is None:
        planes = half_pel_planes(refp)
    return _gather_qpel(refp, planes, mv_q, pad=pad)


def mc_chroma(ref_c, mv_q, *, search: int):
    """Chroma prediction per 8.4.2.2.2: the luma quarter-pel MV lands on
    the eighth-chroma-pel grid (integer q>>3, fraction q&7)."""
    _, hc, wc = ref_c.shape
    pad = search // 2 + 2
    refp = edge_pad(ref_c.to(torch.int32), pad, pad, pad, pad)
    dy, dx = _mv_maps(mv_q, 8)
    iy, fy = dy >> 3, dy & 7
    ix, fx = dx >> 3, dx & 7
    dev = ref_c.device
    rows = (torch.arange(hc, device=dev)[:, None] + iy + pad).long()
    cols = (torch.arange(wc, device=dev)[None, :] + ix + pad).long()
    a = _take(refp, rows, cols)
    b = _take(refp, rows, cols + 1)
    c = _take(refp, rows + 1, cols)
    d = _take(refp, rows + 1, cols + 1)
    return ((8 - fx) * (8 - fy) * a + fx * (8 - fy) * b
            + (8 - fx) * fy * c + fx * fy * d + 32) >> 6


def _decimate_mb_luma(levels: torch.Tensor) -> torch.Tensor:
    """levels (n, mbh, mbw, 4, 4, 4, 4) -> same, low-score MBs zeroed."""
    absl = levels.abs()
    dims = (3, 4, 5, 6)
    veto = (absl >= 2).any(dim=3).any(dim=3).any(dim=3).any(dim=3)
    wts = torch.as_tensor(_DECIMATE_W, device=levels.device)
    score = ((absl == 1).to(torch.int32) * wts).sum(dims)
    keep = veto | (score >= _DECIMATE_THRESHOLD)
    return levels * keep[..., None, None, None, None].to(levels.dtype)


def _inter_luma_residual(cur, pred, qp):
    """(n, H, W) -> levels (n, mbh, mbw, 4, 4, 4, 4) + recon (n, H, W)."""
    n, h, w = cur.shape
    mbh, mbw = h // 16, w // 16
    resid = cur - pred
    blocks = resid.reshape(n, mbh, 4, 4, mbw, 4, 4).permute(0, 1, 4, 2, 5, 3, 6)
    levels = _decimate_mb_luma(quantize(core_transform(blocks), qp=qp,
                                        intra=False))
    rec = inverse_core_transform(dequantize(levels, qp=qp))
    rec = rec.permute(0, 1, 3, 5, 2, 4, 6).reshape(n, h, w)
    return levels, torch.clamp(pred + rec, 0, 255)


def _inter_chroma_residual(cur, pred, qpc):
    """(n, Hc, Wc) -> (dc (n,mbh,mbw,2,2), ac (n,mbh,mbw,2,2,4,4), recon)."""
    n, hc, wc = cur.shape
    mbh, mbw = hc // 8, wc // 8
    resid = cur - pred
    blocks = resid.reshape(n, mbh, 2, 4, mbw, 2, 4).permute(0, 1, 4, 2, 5, 3, 6)
    coefs = core_transform(blocks)
    dc_levels = quantize_chroma_dc(hadamard2x2(coefs[..., 0, 0]), qp=qpc)
    ac_levels = quantize(coefs, qp=qpc, intra=False).clone()
    ac_levels[..., 0, 0] = 0
    full = dequantize(ac_levels, qp=qpc).clone()
    full[..., 0, 0] = dequantize_chroma_dc(dc_levels, qp=qpc)
    rec = inverse_core_transform(full)
    rec = rec.permute(0, 1, 3, 5, 2, 4, 6).reshape(n, hc, wc)
    return dc_levels, ac_levels, torch.clamp(pred + rec, 0, 255)


def encode_p_frame(y, u, v, ref_y, ref_u, ref_v, *, qp, search: int = 8):
    """A batch of P frames, each against its own reference (same
    geometry). Every MB is P_L0_16x16 with a quarter-pel MV (skip is
    decided at entropy time). ``qp``: int or (n,) int32 tensor."""
    n = y.shape[0]
    if not isinstance(qp, torch.Tensor):
        qp = torch.full((n,), int(qp), dtype=torch.int32, device=y.device)
    qp = qp.to(device=y.device, dtype=torch.int32)
    qpc = chroma_qp(qp).to(torch.int32)
    pad = search + 8
    refp = edge_pad(ref_y.to(torch.int32), pad, pad, pad, pad)
    planes = half_pel_planes(refp)
    mv = motion_search(y, ref_y, search=search, refp=refp, planes=planes)
    pred_y = mc_luma(ref_y, mv, search=search, refp=refp, planes=planes)
    pred_u = mc_chroma(ref_u, mv, search=search)
    pred_v = mc_chroma(ref_v, mv, search=search)
    luma, recon_y = _inter_luma_residual(y.to(torch.int32), pred_y, qp)
    udc, uac, recon_u = _inter_chroma_residual(u.to(torch.int32), pred_u, qpc)
    vdc, vac, recon_v = _inter_chroma_residual(v.to(torch.int32), pred_v, qpc)
    return {
        "luma": luma,                                  # (n,mbh,mbw,4,4,4,4)
        "chroma_dc": torch.stack([udc, vdc], 1),       # (n,2,mbh,mbw,2,2)
        "chroma_ac": torch.stack([uac, vac], 1),       # (n,2,mbh,mbw,2,2,4,4)
        "mv": mv,                                      # (n,mbh,mbw,2)
        "recon_y": recon_y.to(torch.uint8),
        "recon_u": recon_u.to(torch.uint8),
        "recon_v": recon_v.to(torch.uint8),
    }


# --- the rate cascade's bit proxy and the chain ---------------------------------

def cost_proxy(*level_arrays: torch.Tensor, batch_ndim: int = 0):
    """Reduce every axis except the leading ``batch_ndim``; float32."""
    tot = 0.0
    for a in level_arrays:
        af = a.to(torch.float32).abs()
        dims = tuple(range(batch_ndim, a.dim()))
        tot = tot + torch.sum((af > 0).to(torch.float32) + torch.log2(1.0 + af),
                              dim=dims)
    return tot


def _pad_mb(y, u, v):
    """Edge-pad (n, H, W) 4:2:0 planes to whole macroblocks."""
    h, w = y.shape[-2], y.shape[-1]
    ph, pw = (-h) % 16, (-w) % 16
    if ph or pw:
        y = edge_pad(y, 0, ph, 0, pw)
        u = edge_pad(u, 0, ph // 2, 0, pw // 2)
        v = edge_pad(v, 0, ph // 2, 0, pw // 2)
    return y, u, v


def _sse(rec_y: torch.Tensor, src_y: torch.Tensor, h: int, w: int):
    err = rec_y[:, :h, :w].to(torch.float32) - src_y.to(torch.float32)
    return (err * err).sum((1, 2))


def encode_chain(y, u, v, qps, *, search: int, deblock: bool, rc=None):
    """Replay chains of one rung.

    y (n, T, H, W), u/v (n, T, H/2, W/2) uint8: the rung's frames as the
    chain DSP was given them (display size); ``qps`` (n, T) int32, slot
    0 the I frame's QP (its anchor applied); ``rc`` None or {"budget",
    "alpha"}, each broadcasting to (n,). Returns int32 levels
    ``i_luma_dc`` (n, R, C, 4, 4), ``i_luma_ac`` (n, R, C, 4, 4, 4, 4),
    ``i_chroma_dc`` (n, 2, R, C, 2, 2), ``i_chroma_ac`` (n, 2, R, C, 2,
    2, 4, 4), ``p_luma``, ``p_chroma_dc``, ``p_chroma_ac`` and ``mv``
    (quarter samples, (y, x)) with dim 1 the T - 1 P frames; ``sse_y``
    (n, T) float32 over the display region; ``recon_y``/``_u``/``_v``
    (n, T, ...) uint8, each frame's filtered reconstruction; with ``rc``
    also ``qp_eff`` (n, T) int32 and ``cost`` (n, T) float32."""
    n, clen, h, w = y.shape
    if clen < 2:
        raise ValueError("chains of >= 2 frames")
    dev = y.device
    flat = lambda p: p.reshape((n * clen,) + tuple(p.shape[2:]))  # noqa: E731
    unflat = lambda p: p.reshape((n, clen) + tuple(p.shape[1:]))  # noqa: E731
    py, pu, pv = (unflat(p) for p in _pad_mb(flat(y), flat(u), flat(v)))
    mbh, mbw = py.shape[-2] // 16, py.shape[-1] // 16
    qps = qps.to(device=dev, dtype=torch.int32)

    i_out = encode_frame(py[:, 0], pu[:, 0], pv[:, 0], qp=qps[:, 0])
    rec = (i_out["recon_y"], i_out["recon_u"], i_out["recon_v"])
    if deblock:
        ibs_v, ibs_h = intra_bs(mbh, mbw, dev)
        rec = deblock_frame(*rec, qp=qps[:, 0], bs_v=ibs_v, bs_h=ibs_h)
        rec = tuple(p.to(torch.uint8) for p in rec)
    recs = [rec]
    sses = [_sse(rec[0], y[:, 0], h, w)]
    if rc is not None:
        budget = torch.clamp(torch.as_tensor(rc["budget"], dtype=torch.float32,
                                             device=dev), min=1.0)
        alpha = torch.as_tensor(rc["alpha"], dtype=torch.float32, device=dev)
        costs = [cost_proxy(i_out["luma_dc"], i_out["luma_ac"],
                            i_out["chroma_dc"], i_out["chroma_ac"],
                            batch_ndim=1)]
        bal = torch.zeros_like(costs[0])
        q_eff = [qps[:, 0]]
    p_out = {"luma": [], "chroma_dc": [], "chroma_ac": [], "mv": []}
    for t in range(1, clen):
        if rc is None:
            q = qps[:, t]
        else:
            adj = torch.clamp(torch.trunc(bal / (3.0 * budget)),
                              -1.0, 8.0).to(torch.int32)
            q = torch.clamp(qps[:, t] + adj, 10, 51)
        pout = encode_p_frame(py[:, t], pu[:, t], pv[:, t], *rec, qp=q,
                              search=search)
        rec = (pout["recon_y"], pout["recon_u"], pout["recon_v"])
        if deblock:
            nz = (pout["luma"] != 0).any(-1).any(-1)      # (n,mbh,mbw,4,4)
            nz4 = nz.permute(0, 1, 3, 2, 4).reshape(n, 4 * mbh, 4 * mbw)
            bsv, bsh = p_bs(nz4, pout["mv"])
            rec = deblock_frame(*rec, qp=q, bs_v=bsv, bs_h=bsh)
            rec = tuple(p.to(torch.uint8) for p in rec)
        recs.append(rec)
        sses.append(_sse(rec[0], y[:, t], h, w))
        for k in p_out:
            p_out[k].append(pout[k])
        if rc is not None:
            cost = cost_proxy(pout["luma"], pout["chroma_dc"],
                              pout["chroma_ac"], batch_ndim=1)
            step = torch.where(alpha > 0, cost * alpha - budget,
                               torch.zeros_like(cost))
            bal = torch.minimum(torch.maximum(bal + step, -3.0 * budget),
                                30.0 * budget)
            costs.append(cost)
            q_eff.append(q)

    out = {"i_luma_dc": i_out["luma_dc"], "i_luma_ac": i_out["luma_ac"],
           "i_chroma_dc": i_out["chroma_dc"],
           "i_chroma_ac": i_out["chroma_ac"],
           "sse_y": torch.stack(sses, 1)}
    for k in p_out:
        out["p_" + k if k != "mv" else k] = torch.stack(p_out[k], 1)
    for i, plane in enumerate("yuv"):
        out[f"recon_{plane}"] = torch.stack([r[i] for r in recs], 1)
    if rc is not None:
        out["qp_eff"] = torch.stack(q_eff, 1)
        out["cost"] = torch.stack(costs, 1)
    return out
