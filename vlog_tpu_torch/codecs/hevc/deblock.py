"""HEVC in-loop deblocking filter (spec 8.7.2) on PyTorch tensors (port of
``vlog_tpu/codecs/hevc/deblock.py``), bit-exact.

The filter is in-loop: the deblocked picture is what a decoder stores
as the reference, so the encoder reconstructs through the same filter.
HEVC filters all vertical edges of a picture first, then all horizontal
ones (8.7.2.1); edges lie on an 8x8 grid and each filter reads 4 and
writes 3 samples per side, so no two same-direction edges touch the same
sample and each pass is one gather, filter and scatter over every edge
at once. The streams here code TUs of 16x16 and up, so edges exist only
on the 16-luma grid and bS is constant per 16x16 cell:

- I pictures: bS 2 on every TU edge (the 32-luma CTB grid); chroma is
  filtered too, on the 16-chroma grid.
- P pictures: bS 1 where either side's TU has coefficients or the MV
  delta reaches 4 quarter pels, else 0; edges at CTB boundaries plus the
  inner 16-grid of partitioned CTBs. Chroma needs bS 2, so only luma.

Every function is batched over the leading dim (one picture per row);
``qp`` is an int32 tensor of shape ``(n,)``, one slice QP per picture.
The beta/tc tables are the spec's Table 8-12.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# Spec Table 8-12: beta' indexed by Q = Clip3(0, 51, qp).
BETA_TBL = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10,
    11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34,
    36, 38, 40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64,
], np.int32)
# Spec Table 8-12: tc' indexed by Q = Clip3(0, 53, qp + 2*(bS-1)).
TC_TBL = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6,
    7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 22, 24,
], np.int32)
_TABLES = {"beta": BETA_TBL, "tc": TC_TBL}


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_TABLES[name], device=device)


def _rep2(x: torch.Tensor) -> torch.Tensor:
    """Repeat each element of the last two dims twice (CTB -> 16-cell)."""
    return x.repeat_interleave(2, -2).repeat_interleave(2, -1)


# ---------------------------------------------------------------------------
# Boundary strengths (cell granularity: bS is constant per 16x16 cell)
# ---------------------------------------------------------------------------

def intra_bs(ctbh: int, ctbw: int, device):
    """(bs_v, bs_h) for an all-intra picture, shared by every picture of
    a batch: bs_v (Ev, H16) int32 holds vertical edge k at x = 16*(k+1)
    per 16-line cell row; only CTB boundaries (odd k) carry a TU edge,
    at bS 2. bs_h mirrors it for horizontal edges."""
    h16, w16 = 2 * ctbh, 2 * ctbw
    bs_v = np.where((np.arange(w16 - 1) % 2 == 1)[:, None], 2, 0)
    bs_h = np.where((np.arange(h16 - 1) % 2 == 1)[:, None], 2, 0)
    return (torch.as_tensor(np.broadcast_to(bs_v, (w16 - 1, h16)).astype(np.int32),
                            device=device),
            torch.as_tensor(np.broadcast_to(bs_h, (h16 - 1, w16)).astype(np.int32),
                            device=device))


def p_bs(part: torch.Tensor, cbf_cells: torch.Tensor, mv: torch.Tensor):
    """Boundary strengths for a batch of P pictures.

    part: (n, R, C) int32 partition code per CTB (0 = 2Nx2N).
    cbf_cells: (n, 2R, 2C) bool, the TU holding the cell has coefficients.
    mv: (n, 2R, 2C, 2) int32 quarter-pel MVs per 16-cell.
    Returns (bs_v, bs_h): (n, Ev, H16) / (n, Eh, W16) int32.
    """
    cbf = cbf_cells.to(torch.int32)
    h16, w16 = cbf.shape[-2], cbf.shape[-1]
    dev = cbf.device
    part_cells = _rep2(part)                                   # (n, 2R, 2C)

    cond_v = (((cbf[..., :, :-1] | cbf[..., :, 1:]) > 0)
              | ((mv[:, :, 1:] - mv[:, :, :-1]).abs() >= 4).any(-1))
    kv = torch.arange(w16 - 1, device=dev)
    ctb_v = (kv % 2) == 1                                      # (Ev,)
    # interior edge k (even) lies inside CTB column k//2: a TU16 edge
    # exists there only when that CTB is partitioned
    inner_v = part_cells[:, :, (kv // 2) * 2] != 0             # (n, H16, Ev)
    exists_v = ctb_v | (~ctb_v & inner_v)
    bs_v = (exists_v & cond_v).to(torch.int32).transpose(-1, -2)

    cond_h = (((cbf[..., :-1, :] | cbf[..., 1:, :]) > 0)
              | ((mv[:, 1:] - mv[:, :-1]).abs() >= 4).any(-1))
    kh = torch.arange(h16 - 1, device=dev)
    ctb_h = ((kh % 2) == 1)[:, None]
    inner_h = part_cells[:, (kh // 2) * 2, :] != 0             # (n, Eh, W16)
    exists_h = ctb_h | (~ctb_h & inner_h)
    return bs_v.contiguous(), (exists_h & cond_h).to(torch.int32)


# ---------------------------------------------------------------------------
# Edge filters: win (n, E, L, 8) = [p3 p2 p1 p0 q0 q1 q2 q3] per line
# ---------------------------------------------------------------------------

def _filter_luma(win: torch.Tensor, bs_seg: torch.Tensor,
                 qp: torch.Tensor) -> torch.Tensor:
    """Spec 8.7.2.5.3 (decisions) + 8.7.2.5.6/8.7.2.5.7 (filters).

    win: (n, E, L, 8) int32, L a multiple of 4; bs_seg: (E, L//4) or
    (n, E, L//4) int32 per 4-line segment; qp (n,) int32.
    """
    n, e, l, _ = win.shape
    w4 = win.reshape(n, e, l // 4, 4, 8)
    p3, p2, p1, p0, q0, q1, q2, q3 = w4.unbind(-1)            # (n, E, S, 4)

    qpb = qp.reshape(-1, 1, 1)
    beta = _table("beta", win.device)[torch.clamp(qpb, 0, 51)]  # (n, 1, 1)
    tc = _table("tc", win.device)[torch.clamp(qpb + 2 * (bs_seg - 1), 0, 53)]

    dp = (p2 - 2 * p1 + p0).abs()                             # per line
    dq = (q2 - 2 * q1 + q0).abs()
    dp03 = dp[..., 0] + dp[..., 3]                            # (n, E, S)
    dq03 = dq[..., 0] + dq[..., 3]
    filt = (bs_seg > 0) & (dp03 + dq03 < beta)

    def strong_line(i):
        return ((2 * (dp[..., i] + dq[..., i]) < (beta >> 2))
                & ((p3[..., i] - p0[..., i]).abs()
                   + (q0[..., i] - q3[..., i]).abs() < (beta >> 3))
                & ((p0[..., i] - q0[..., i]).abs() < ((5 * tc + 1) >> 1)))

    strong = filt & strong_line(0) & strong_line(3)           # (n, E, S)

    tcl = tc[..., None]                                       # to lines
    c2 = 2 * tcl

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    p0s = clip((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0 - c2, p0 + c2)
    p1s = clip((p2 + p1 + p0 + q0 + 2) >> 2, p1 - c2, p1 + c2)
    p2s = clip((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2 - c2, p2 + c2)
    q0s = clip((q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3, q0 - c2, q0 + c2)
    q1s = clip((q2 + q1 + q0 + p0 + 2) >> 2, q1 - c2, q1 + c2)
    q2s = clip((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2 - c2, q2 + c2)

    # normal filter: per-line gate |delta| < 10*tc (8.7.2.5.7)
    d0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    nf = d0.abs() < 10 * tcl
    delta = clip(d0, -tcl, tcl)
    p0n = torch.clamp(p0 + delta, 0, 255)
    q0n = torch.clamp(q0 - delta, 0, 255)
    thr_side = (beta + (beta >> 1)) >> 3
    side_p = (dp03 < thr_side)[..., None]                     # per segment
    side_q = (dq03 < thr_side)[..., None]
    tch = tcl >> 1
    # p0 moves by +delta, q0 by -delta; each side's p1/q1 term carries
    # its own side's sign
    dp1 = clip((((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -tch, tch)
    dq1 = clip((((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -tch, tch)
    p1n = torch.clamp(p1 + dp1, 0, 255)
    q1n = torch.clamp(q1 + dq1, 0, 255)

    f = filt[..., None]
    fs = f & strong[..., None]
    fn = f & nf
    p0o = torch.where(fs, p0s, torch.where(fn, p0n, p0))
    q0o = torch.where(fs, q0s, torch.where(fn, q0n, q0))
    p1o = torch.where(fs, p1s, torch.where(fn & side_p, p1n, p1))
    q1o = torch.where(fs, q1s, torch.where(fn & side_q, q1n, q1))
    p2o = torch.where(fs, p2s, p2)
    q2o = torch.where(fs, q2s, q2)
    out = torch.stack([p3, p2o, p1o, p0o, q0o, q1o, q2o, q3], -1)
    return out.reshape(n, e, l, 8)


def _filter_chroma(win: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """Spec 8.7.2.5.5: bS-2 chroma filter, win (n, E, L, 4) = [p1 p0 q0
    q1]; tc indexed at qp + 2 (bS is always 2 here)."""
    p1, p0, q0, q1 = win.unbind(-1)
    tc = _table("tc", win.device)[torch.clamp(qp + 2, 0, 53)].reshape(-1, 1, 1)
    d = (4 * (q0 - p0) + p1 - q1 + 4) >> 3
    delta = torch.minimum(torch.maximum(d, -tc), tc)
    return torch.stack([p1, torch.clamp(p0 + delta, 0, 255),
                        torch.clamp(q0 - delta, 0, 255), q1], -1)


# ---------------------------------------------------------------------------
# Passes: gather non-overlapping windows, filter, scatter back
# ---------------------------------------------------------------------------

def _edge_cols(width: int, lo: int, hi: int, device) -> torch.Tensor | None:
    """(Ev, hi-lo) column indices of the windows around every interior
    16-multiple x, or None when the plane has no interior edge."""
    ev = width // 16 - 1
    if ev <= 0:
        return None
    xs = (torch.arange(ev, device=device) + 1) * 16
    return xs[:, None] + torch.arange(lo, hi, device=device)[None, :]


def _luma_pass_v(plane: torch.Tensor, bs_v: torch.Tensor,
                 qp: torch.Tensor) -> torch.Tensor:
    """All vertical luma edges at once. plane (n, H, W) int32; bs_v
    (Ev, H16) or (n, Ev, H16) per cell, repeated to 4-line segments."""
    cols = _edge_cols(plane.shape[-1], -4, 4, plane.device)
    if cols is None:
        return plane
    win = plane[:, :, cols].permute(0, 2, 1, 3)               # (n, Ev, H, 8)
    out = _filter_luma(win, bs_v.repeat_interleave(4, -1), qp)
    plane = plane.clone()
    plane[:, :, cols] = out.permute(0, 2, 1, 3)
    return plane


def _luma_pass_h(plane, bs_h, qp):
    """Horizontal edges = the vertical pass on the transpose (the p side
    is above the edge, which transposition maps to the left)."""
    return _luma_pass_v(plane.transpose(-1, -2), bs_h, qp).transpose(-1, -2)


def _chroma_pass_v(plane: torch.Tensor, qp: torch.Tensor) -> torch.Tensor:
    """Intra-picture chroma: every interior 16-chroma column is a bS-2
    CTB/TU boundary. plane (n, Hc, Wc) int32."""
    cols = _edge_cols(plane.shape[-1], -2, 2, plane.device)
    if cols is None:
        return plane
    win = plane[:, :, cols].permute(0, 2, 1, 3)               # (n, Ev, Hc, 4)
    plane = plane.clone()
    plane[:, :, cols] = _filter_chroma(win, qp).permute(0, 2, 1, 3)
    return plane


def deblock_picture(y, u, v, *, qp, qpc, bs_v, bs_h, chroma: bool):
    """Deblock a batch of reconstructed pictures per spec 8.7.2.

    y (n, H, W), u/v (n, H/2, W/2) integer planes; ``qp``/``qpc`` (n,)
    int32; bS from :func:`intra_bs` / :func:`p_bs`; ``chroma`` True only
    for intra pictures (chroma filters at bS 2). Returns (y, u, v) int32
    in [0, 255], contiguous.
    """
    y = _luma_pass_v(y.to(torch.int32), bs_v, qp)
    y = _luma_pass_h(y, bs_h, qp)
    u, v = u.to(torch.int32), v.to(torch.int32)
    if chroma:
        u = _chroma_pass_v(u, qpc)
        v = _chroma_pass_v(v, qpc)
        u = _chroma_pass_v(u.transpose(-1, -2), qpc).transpose(-1, -2)
        v = _chroma_pass_v(v.transpose(-1, -2), qpc).transpose(-1, -2)
    return y.contiguous(), u.contiguous(), v.contiguous()
