"""P-frame DSP over a batch of frames: motion search, motion
compensation, inter residual coding (port of
``vlog_tpu/codecs/h264/inter.py``, bit-exact).

- Full-search integer ME: the reference scans the offsets with a strict
  ``<`` from (0,0) first, then raster order. That keeps the first offset
  reaching the minimum cost, which is exactly ``argmin`` (first
  occurrence) over the costs stacked in that order; the port evaluates
  one row of offsets per step and takes the argmin.
- Half- then quarter-pel refinement: eight candidates per stage seeded
  with the previous winner's cost (the winner is kept on ties), again an
  argmin over [seed, candidates...].
- Motion compensation gathers from the edge-padded reference and the
  spec's six-tap half-sample planes; chroma is the 8.4.2.2.2 bilinear
  blend.
- Residuals: all-16-coefficient 4x4 luma with MB decimation, chroma with
  the 2x2 DC Hadamard, inter rounding offsets.

MVs are (n, mbh, mbw, 2) int32 in quarter-pel units, (y, x) order.
"""

from __future__ import annotations

import numpy as np
import torch

from vlog_tpu_torch.codecs.h264.encoder import chroma_qp, to_host
from vlog_tpu_torch.obs.trace import stage
from vlog_tpu_torch.ops.transform import (
    core_transform,
    dequantize,
    dequantize_chroma_dc,
    hadamard2x2,
    inverse_core_transform,
    quantize,
    quantize_chroma_dc,
)

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
    with stage("h264.me"):
        refp = edge_pad(ref_y.to(torch.int32), pad, pad, pad, pad)
        planes = half_pel_planes(refp)
        mv = motion_search(y, ref_y, search=search, refp=refp, planes=planes)
    with stage("h264.residual"):
        pred_y = mc_luma(ref_y, mv, search=search, refp=refp, planes=planes)
        pred_u = mc_chroma(ref_u, mv, search=search)
        pred_v = mc_chroma(ref_v, mv, search=search)
        luma, recon_y = _inter_luma_residual(y.to(torch.int32), pred_y, qp)
        udc, uac, recon_u = _inter_chroma_residual(u.to(torch.int32), pred_u,
                                                   qpc)
        vdc, vac, recon_v = _inter_chroma_residual(v.to(torch.int32), pred_v,
                                                   qpc)
    return {
        "luma": luma,                                  # (n,mbh,mbw,4,4,4,4)
        "chroma_dc": torch.stack([udc, vdc], 1),       # (n,2,mbh,mbw,2,2)
        "chroma_ac": torch.stack([uac, vac], 1),       # (n,2,mbh,mbw,2,2,4,4)
        "mv": mv,                                      # (n,mbh,mbw,2)
        "recon_y": recon_y.to(torch.uint8),
        "recon_u": recon_u.to(torch.uint8),
        "recon_v": recon_v.to(torch.uint8),
    }


def p_frame_levels(out: dict) -> dict:
    """One frame's ``encode_p_frame`` output -> host numpy dict for the
    entropy coder."""
    return {k: to_host(out[k]).astype(np.int32)
            for k in ("luma", "chroma_dc", "chroma_ac", "mv")}
