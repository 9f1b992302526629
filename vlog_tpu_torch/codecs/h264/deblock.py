"""H.264 in-loop deblocking (spec 8.7) over a batch of frames (port of
``vlog_tpu/codecs/h264/deblock.py``, bit-exact).

The filter is in-loop, so the reconstruction must follow the spec order
exactly. Same wavefront as the reference: op ``idx`` (0-3 vertical, 4-7
horizontal edges) of MB (r, c) runs at phase ``8*(r + c) + idx``, which is
a linear extension of the spec's raster read/write order. Each phase is
one batched gather/filter/scatter over the anti-diagonal's MBs and over
every frame of the batch; U and V are filtered together as one stacked
chroma batch (same bS and thresholds).
"""

from __future__ import annotations

import numpy as np
import torch

from vlog_tpu_torch.codecs.h264.encoder import chroma_qp

# Spec Table 8-16 (alpha, beta by indexA/indexB 0..51).
ALPHA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6, 7, 8,
    9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45, 50, 56, 63,
    71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255,
], np.int32)
BETA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3, 3, 3,
    3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13,
    13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18,
], np.int32)
# Spec Table 8-17: tc0 by (bS-1, indexA). Row 0 is bS=1.
TC0 = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5,
     6, 6, 7, 8, 9, 10, 11, 13],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,
     1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 7,
     8, 8, 10, 11, 12, 13, 15, 17],
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9,
     10, 11, 13, 14, 16, 18, 20, 23, 25],
], np.int32)


# ---------------------------------------------------------------------------
# Boundary strengths, (n, mbh, mbw, 4, 4) int32 [frame, r, c, edge, segment]
# ---------------------------------------------------------------------------

def intra_bs(mbh: int, mbw: int, device):
    """(bs_v, bs_h) of an all-Intra_16x16 frame, (mbh, mbw, 4, 4): MB
    edges 4, internal 3 (picture edges are masked off in the filter)."""
    bs = torch.full((mbh, mbw, 4, 4), 3, dtype=torch.int32, device=device)
    bs[:, :, 0, :] = 4
    return bs, bs


def p_bs(nz4: torch.Tensor, mv: torch.Tensor):
    """Boundary strengths for a batch of P frames.

    nz4 (n, 4*mbh, 4*mbw): 4x4 luma block has nonzero levels; mv
    (n, mbh, mbw, 2) quarter-pel. bS 2 where either side is coded, else
    1 across MB edges whose MV delta is >= 4 on a component, else 0.
    """
    nz4 = nz4.to(torch.int32)
    n, mbh, mbw = mv.shape[0], mv.shape[1], mv.shape[2]
    zcol = torch.zeros_like(nz4[:, :, :1])
    zrow = torch.zeros_like(nz4[:, :1, :])
    nzl = torch.cat([zcol, nz4[:, :, :-1]], 2)          # left neighbour
    nzu = torch.cat([zrow, nz4[:, :-1, :]], 1)          # upper neighbour
    pair_v = (nz4 | nzl) > 0
    pair_h = (nz4 | nzu) > 0
    mvl = torch.cat([torch.zeros_like(mv[:, :, :1]), mv[:, :, :-1]], 2)
    mvu = torch.cat([torch.zeros_like(mv[:, :1]), mv[:, :-1]], 1)
    mv_v = ((mv - mvl).abs() >= 4).any(-1)              # (n, mbh, mbw)
    mv_h = ((mv - mvu).abs() >= 4).any(-1)

    def shape(p, mvd):
        bs = torch.where(p, 2, 0).to(torch.int32)
        mvterm = torch.where(mvd[..., None, None], 1, 0).to(torch.int32)
        edge0 = torch.maximum(bs[:, :, :, 0:1, :], mvterm)
        return torch.cat([edge0, bs[:, :, :, 1:, :]], 3)

    # vertical edge i at x=16c+4i, segment s at block row 4r+s -> [r,c,i,s]
    pv = pair_v.reshape(n, mbh, 4, mbw, 4).permute(0, 1, 3, 4, 2)
    # horizontal edge i at y=16r+4i, segment s at block col 4c+s
    ph = pair_h.reshape(n, mbh, 4, mbw, 4).permute(0, 1, 3, 2, 4)
    return shape(pv, mv_v), shape(ph, mv_h)


# ---------------------------------------------------------------------------
# Line filters: win (..., 8) = [p3 p2 p1 p0 q0 q1 q2 q3]; thresholds are
# per frame, shaped to broadcast against the lines (..., )
# ---------------------------------------------------------------------------

def _clip3(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _tc0_of(bs, tc0):
    """tc0[clip(bs,1,3)-1] with tc0 a list of three broadcastable rows."""
    return torch.where(bs <= 1, tc0[0], torch.where(bs == 2, tc0[1], tc0[2]))


def _filter_luma_lines(win, bs, alpha, beta, tc0):
    """Spec 8.7.2.3 (bS 1..3) + 8.7.2.4 (bS 4) on int32 lines."""
    p3, p2, p1, p0, q0, q1, q2, q3 = win.unbind(-1)
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha)
            & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta

    c0 = _tc0_of(bs, tc0)
    tc = c0 + ap.to(torch.int32) + aq.to(torch.int32)
    delta = _clip3(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0n = torch.clamp(p0 + delta, 0, 255)
    q0n = torch.clamp(q0 - delta, 0, 255)
    avg = (p0 + q0 + 1) >> 1
    p1n = torch.where(ap, p1 + _clip3((p2 + avg - 2 * p1) >> 1, -c0, c0), p1)
    q1n = torch.where(aq, q1 + _clip3((q2 + avg - 2 * q1) >> 1, -c0, c0), q1)

    small = (p0 - q0).abs() < ((alpha >> 2) + 2)
    strong_p = ap & small
    strong_q = aq & small
    p0s = torch.where(strong_p, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                      (2 * p1 + p0 + q1 + 2) >> 2)
    p1s = torch.where(strong_p, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    p2s = torch.where(strong_p, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    q0s = torch.where(strong_q, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                      (2 * q1 + q0 + p1 + 2) >> 2)
    q1s = torch.where(strong_q, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    q2s = torch.where(strong_q, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)

    is4 = bs == 4
    f4 = filt & is4
    return torch.stack([
        p3,
        torch.where(f4, p2s, p2),
        torch.where(filt, torch.where(is4, p1s, p1n), p1),
        torch.where(filt, torch.where(is4, p0s, p0n), p0),
        torch.where(filt, torch.where(is4, q0s, q0n), q0),
        torch.where(filt, torch.where(is4, q1s, q1n), q1),
        torch.where(f4, q2s, q2),
        q3,
    ], -1)


def _filter_chroma_lines(win, bs, alpha, beta, tc0):
    """Chroma edge filter: win (..., 4) = [p1 p0 q0 q1]."""
    p1, p0, q0, q1 = win.unbind(-1)
    filt = ((bs > 0) & ((p0 - q0).abs() < alpha)
            & ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta))
    tc = _tc0_of(bs, tc0) + 1
    delta = _clip3(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    p0n = torch.clamp(p0 + delta, 0, 255)
    q0n = torch.clamp(q0 - delta, 0, 255)
    p0s = (2 * p1 + p0 + q1 + 2) >> 2
    q0s = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    return torch.stack([
        p1,
        torch.where(filt, torch.where(is4, p0s, p0n), p0),
        torch.where(filt, torch.where(is4, q0s, q0n), q0),
        q1,
    ], -1)


# ---------------------------------------------------------------------------
# Wavefront frame filter
# ---------------------------------------------------------------------------

def _edge_pass(plane, rows, cols, seg_bs, mask, thr, *, mb, vertical, chroma):
    """Filter one edge per active MB of a diagonal, in place on ``plane``.

    plane (B, H, W); rows/cols index the (nd, mb, wwin) lines window
    (vertical edges) or its transpose (horizontal); seg_bs (B, nd, 4);
    mask (nd,); thr = (alpha, beta, tc0 rows), each (B, 1, 1)."""
    win = plane[:, rows, cols]                       # (B, nd, mb, wwin) | (B, nd, wwin, mb)
    if not vertical:
        win = win.transpose(2, 3)
    bs_l = seg_bs.repeat_interleave(mb // 4, dim=2)  # (B, nd, mb)
    fn = _filter_chroma_lines if chroma else _filter_luma_lines
    out = fn(win, bs_l, *thr)
    out = torch.where(mask[None, :, None, None], out, win)
    if not vertical:
        out = out.transpose(2, 3)
    plane[:, rows, cols] = out


def _thresholds(qp: torch.Tensor):
    """(alpha, beta, [tc0 bS1, bS2, bS3]) per frame, shaped (B, 1, 1) to
    broadcast against (B, nd, lines)."""
    dev = qp.device
    ia = torch.clamp(qp, 0, 51).long()
    sh = lambda t: t[ia].reshape(-1, 1, 1)          # noqa: E731
    tc0 = torch.as_tensor(TC0, device=dev)
    return (sh(torch.as_tensor(ALPHA, device=dev)),
            sh(torch.as_tensor(BETA, device=dev)),
            [sh(tc0[k]) for k in range(3)])


def deblock_frame(y, u, v, *, qp, bs_v, bs_h):
    """Deblock a batch of reconstructed frames (spec 8.7 order).

    y (n, H, W), u/v (n, H/2, W/2) integer planes; ``qp`` int or (n,)
    int32; bS arrays (n, mbh, mbw, 4, 4) or unbatched (mbh, mbw, 4, 4).
    Returns filtered (y, u, v) as int32, values in [0, 255]."""
    n, h, w = y.shape
    mbh, mbw = h // 16, w // 16
    dev = y.device
    if not isinstance(qp, torch.Tensor):
        qp = torch.full((n,), int(qp), dtype=torch.int32, device=dev)
    qp = qp.to(device=dev, dtype=torch.int32)
    if bs_v.dim() == 4:
        bs_v = bs_v[None].expand(n, -1, -1, -1, -1)
        bs_h = bs_h[None].expand(n, -1, -1, -1, -1)
    yy = y.to(torch.int32).clone()
    cc = torch.cat([u, v], 0).to(torch.int32)        # (2n, Hc, Wc): U then V
    hc, wc = cc.shape[1], cc.shape[2]
    thr_y = _thresholds(qp)
    thr_c = _thresholds(chroma_qp(qp).to(torch.int32))
    thr_c = (torch.cat([thr_c[0]] * 2), torch.cat([thr_c[1]] * 2),
             [torch.cat([t] * 2) for t in thr_c[2]])
    ar16 = torch.arange(16, device=dev)
    ar8 = torch.arange(8, device=dev)
    ar4 = torch.arange(4, device=dev)

    for k in range(mbh + mbw - 1):
        r_idx = torch.arange(max(0, k - mbw + 1), min(mbh - 1, k) + 1,
                             device=dev)
        c_idx = k - r_idx
        segs_v = bs_v[:, r_idx, c_idx]               # (n, nd, 4, 4)
        segs_h = bs_h[:, r_idx, c_idx]
        for i in range(4):                           # vertical edges, x order
            m = (c_idx > 0) | (i > 0)                # picture-left edge off
            rows = (r_idx[:, None] * 16 + ar16)[:, :, None]
            cols = torch.clamp(c_idx[:, None] * 16 + 4 * i - 4 + ar8, 0, w - 1)
            _edge_pass(yy, rows, cols[:, None, :], segs_v[:, :, i], m, thr_y,
                       mb=16, vertical=True, chroma=False)
            if i % 2 == 0:                           # chroma edges at x/2
                rows = (r_idx[:, None] * 8 + ar8)[:, :, None]
                cols = torch.clamp(c_idx[:, None] * 8 + 2 * i - 2 + ar4,
                                   0, wc - 1)
                _edge_pass(cc, rows, cols[:, None, :],
                           torch.cat([segs_v[:, :, i]] * 2), m, thr_c,
                           mb=8, vertical=True, chroma=True)
        for j in range(4):                           # horizontal edges, y order
            m = (r_idx > 0) | (j > 0)                # picture-top edge off
            rows = torch.clamp(r_idx[:, None] * 16 + 4 * j - 4 + ar8, 0, h - 1)
            cols = (c_idx[:, None] * 16 + ar16)[:, None, :]
            _edge_pass(yy, rows[:, :, None], cols, segs_h[:, :, j], m, thr_y,
                       mb=16, vertical=False, chroma=False)
            if j % 2 == 0:
                rows = torch.clamp(r_idx[:, None] * 8 + 2 * j - 2 + ar4,
                                   0, hc - 1)
                cols = (c_idx[:, None] * 8 + ar8)[:, None, :]
                _edge_pass(cc, rows[:, :, None], cols,
                           torch.cat([segs_h[:, :, j]] * 2), m, thr_c,
                           mb=8, vertical=False, chroma=True)
    return yy, cc[:n], cc[n:]
