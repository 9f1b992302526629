"""HEVC DSP on PyTorch tensors (port of ``vlog_tpu/codecs/hevc/jax_core.py``):
intra row scan, motion search, quarter-pel MC, inter residuals, in-loop
deblocking and the I+P chain with the device rate-control cascade.

Bit-exact with the reference. Every function takes a leading batch dim
where the reference uses ``vmap`` (frames, or the chains of a dispatch),
and QP is an int32 tensor with one value per batch row, so the quantizer's
shifts and table lookups broadcast per row.

- **Transforms.** CUDA has no integer matmul, and float32 is not exact
  here (the second 32-point stage sums to about 2^27). The N-point
  products run in float64: the inputs are integers and every partial sum
  stays far below 2^53, so the result is exact in any summation order. It
  is cast back to int32 before the rounding shifts, which floor on
  negatives as the reference's do.
- **Intra.** All three planes use exact-vertical prediction (mode 26).
  CTB row 0 is a loop over columns (each block predicts from the left
  neighbour's reconstructed top-right pixel), every later row is one
  batched step whose input is the row above's bottom line.
- **Motion search** is the reference's: integer SADs over every offset
  in the reference's order ((0, 0) first, then raster), the first
  minimum winning; then half- and quarter-pel refinement over the 8
  neighbours in order, a candidate replacing the best only when strictly
  better.
- **MC.** Luma is the spec's two-stage 8-tap (table 8-11), chroma the
  4-tap eighth-pel filter (table 8-32): the horizontal pass makes one
  un-normalised plane per fraction (``torch.roll``, wrapping as
  ``jnp.roll`` does; the pads keep every read clear of the wrapped ring),
  the vertical pass gathers 8 (4) rows from the plane each pixel's
  fraction selects. Every gather index stays in range by the pads.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from vlog_tpu_torch.codecs.h264.inter import edge_pad
from vlog_tpu_torch.codecs.hevc import deblock as dbk
from vlog_tpu_torch.codecs.hevc.transform import (LEVEL_SCALE, QUANT_SCALE,
                                                  T8, T16, T32, _QPC)
from vlog_tpu_torch.ops.bitproxy import cost_proxy

I32 = torch.int32

# luma 8-tap rows (fraction 0 is the 64-delta so every case unifies)
_LTAPS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], np.int32)
# chroma 4-tap rows per eighth fraction
_CTAPS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], np.int32)

_TABLES = {
    "qpc": np.array(_QPC + [0] * 16, np.int32),   # padded; >= 43 computed
    "quant": np.asarray(QUANT_SCALE, np.int32),
    "level16": np.asarray(LEVEL_SCALE, np.int32) * 16,
    "ltaps": _LTAPS,
    "ctaps": _CTAPS,
}
_MATS = {3: T8, 4: T16, 5: T32}

# partition codes per CTB
PART_2Nx2N, PART_2NxN, PART_Nx2N = 0, 1, 2
# mode decision penalty per extra MV (SAD units), scaled by 2^(qp/6)
_PART_PENALTY = 24


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_TABLES[name], device=device)


@functools.lru_cache(maxsize=None)
def _mat(log2n: int, device: torch.device) -> torch.Tensor:
    """The N-point transform matrix in float64 (exact integers)."""
    return torch.as_tensor(np.asarray(_MATS[log2n], np.float64), device=device)


def _rows(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """View a per-row (n,) tensor so it broadcasts against ``x`` (n, ...)."""
    return q.reshape(q.shape + (1,) * (x.dim() - q.dim()))


def _one_shl(s: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(s) << s


def _rep(x: torch.Tensor, k: int) -> torch.Tensor:
    """Repeat each element of dims 1 and 2 (a batch of grids) ``k`` times."""
    return x.repeat_interleave(k, 1).repeat_interleave(k, 2)


def chroma_qp_traced(qp: torch.Tensor) -> torch.Tensor:
    """Spec table 8-10 chroma QP per row (qp int32)."""
    qpi = torch.clamp(qp, 0, 51)
    return torch.where(qpi < 43,
                       _table("qpc", qp.device)[torch.clamp(qpi, max=42)],
                       qpi - 6)


def _imm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul through float64 (see the module docstring)."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(I32)


def _fwd(res: torch.Tensor, log2n: int) -> torch.Tensor:
    m = _mat(log2n, res.device)
    s1, s2 = log2n - 1, log2n + 6
    tmp = (_imm(m, res) + (1 << (s1 - 1))) >> s1
    return (_imm(tmp, m.T) + (1 << (s2 - 1))) >> s2


def _inv(coeff: torch.Tensor, log2n: int) -> torch.Tensor:
    m = _mat(log2n, coeff.device)
    e = torch.clamp((_imm(m.T, coeff) + 64) >> 7, -32768, 32767)
    r = (_imm(e, m) + (1 << 11)) >> 12          # 8-bit: shift 20-8
    return torch.clamp(r, -32768, 32767)


def _quant(coeff: torch.Tensor, qp: torch.Tensor, log2n: int) -> torch.Tensor:
    """qp broadcasts against ``coeff``. The rounding offset is written
    as 171 << (qbits-9), which stays in int32 at every QP (see the
    reference)."""
    tr_shift = 15 - 8 - log2n
    qbits = 14 + qp // 6 + tr_shift
    f = _table("quant", coeff.device)[qp % 6]
    offset = (171 * torch.ones_like(qbits)) << (qbits - 9)
    level = (coeff.abs() * f + offset) >> qbits
    return torch.sign(coeff) * torch.clamp(level, 0, 32767)


def _dequant(level: torch.Tensor, qp: torch.Tensor, log2n: int) -> torch.Tensor:
    """Spec 8.6.3 restated int32-safely (derivation in the reference):
    with a = level*16*levelScale, d = a << (per-bd) when per >= bd, else
    (a + 1 << (bd-per-1)) >> (bd-per)."""
    bd = 8 + log2n - 5
    per = qp // 6
    a = level * _table("level16", level.device)[qp % 6]
    d = torch.where(per >= bd,
                    a * _one_shl(torch.clamp(per - bd, min=0)),
                    (a + _one_shl(torch.clamp(bd - per - 1, min=0)))
                    >> torch.clamp(bd - per, min=0))
    return torch.clamp(d, -32768, 32767)


def _code_blocks(src: torch.Tensor, pred: torch.Tensor, qp: torch.Tensor,
                 log2n: int):
    """src/pred (n, ..., N, N) int32, qp (n,) -> (levels, recon) int32."""
    q = _rows(qp, src)
    levels = _quant(_fwd(src - pred, log2n), q, log2n)
    rec = _inv(_dequant(levels, q, log2n), log2n)
    return levels, torch.clamp(pred + rec, 0, 255)


def _encode_plane(plane: torch.Tensor, qp: torch.Tensor, n: int):
    """Planes (B, H, W) uint8 -> levels (B, R, C, N, N) int32, recon
    (B, H, W) uint8; qp (B,) already chroma-mapped for chroma."""
    log2n = n.bit_length() - 1
    b, h, w = plane.shape
    rows, cols = h // n, w // n
    src = plane.to(I32).reshape(b, rows, n, cols, n).permute(0, 1, 3, 2, 4)

    # CTB row 0: the left neighbour's top-right pixel fills the block
    carry = torch.full((b,), 128, dtype=I32, device=plane.device)
    lev0, rec0 = [], []
    for c in range(cols):
        pred = carry.reshape(b, 1, 1).expand(b, n, n)
        lv, rc = _code_blocks(src[:, 0, c], pred, qp, log2n)
        carry = rc[:, 0, n - 1]
        lev0.append(lv)
        rec0.append(rc)
    levels = [torch.stack(lev0, 1)]
    recons = [torch.stack(rec0, 1)]
    # rows 1..R-1: one batched step each from the row above's bottom line
    for r in range(1, rows):
        bottom = recons[-1][:, :, n - 1, :]                   # (B, C, N)
        pred = bottom.reshape(b, cols, 1, n).expand(b, cols, n, n)
        lv, rc = _code_blocks(src[:, r], pred, qp, log2n)
        levels.append(lv)
        recons.append(rc)
    recon = torch.stack(recons, 1).permute(0, 1, 3, 2, 4).reshape(b, h, w)
    return torch.stack(levels, 1), recon.to(torch.uint8)


def encode_frame_dsp(y, u, v, qp, *, deblock: bool = False):
    """Intra pass for a batch of padded frames (the reference's
    ``encode_frame_dsp``; its ``encode_batch_dsp`` is this call on a
    batch): y (B, H, W), u/v (B, H/2, W/2) uint8, qp (B,) int32.
    Returns per-CTB levels and the bit-exact reconstruction of all
    three planes (spec-8.7.2 deblocked when ``deblock``: intra pictures
    filter luma and chroma, every TU edge at bS 2)."""
    qp = torch.as_tensor(qp, dtype=I32, device=y.device).reshape(-1)
    qpc = chroma_qp_traced(qp)
    ly, ry = _encode_plane(y, qp, 32)
    lu, ru = _encode_plane(u, qpc, 16)
    lv, rv = _encode_plane(v, qpc, 16)
    if deblock:
        h, w = y.shape[-2:]
        bs_v, bs_h = dbk.intra_bs(h // 32, w // 32, y.device)
        rec = dbk.deblock_picture(ry, ru, rv, qp=qp, qpc=qpc, bs_v=bs_v,
                                  bs_h=bs_h, chroma=True)
        ry, ru, rv = (p.to(torch.uint8) for p in rec)
    return (ly, lu, lv), (ry, ru, rv)


# ---------------------------------------------------------------- inter

def _hfiltered_planes(refp: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Horizontal pass: (B, Hp, Wp) int32 -> (B, F, Hp, Wp), one
    un-normalised plane per fraction row (fraction 0 = ref * 64, so the
    stack is at uniform gain 64)."""
    planes = []
    center = taps.shape[1] // 2 - 1     # tap k applies at offset k-center
    for f in range(taps.shape[0]):
        if f == 0:
            planes.append(refp * 64)
            continue
        acc = None
        for k in range(taps.shape[1]):
            t = int(taps[f, k])
            if t == 0:
                continue
            term = t * torch.roll(refp, center - k, dims=-1)
            acc = term if acc is None else acc + term
        planes.append(acc)
    return torch.stack(planes, 1)


def _mc_qpel(planes: torch.Tensor, mv_q: torch.Tensor, *, pad: int, h: int,
             w: int, n: int, frac_bits: int, taps: str) -> torch.Tensor:
    """Per-pixel plane select by the horizontal fraction, then the
    vertical filter as one gather per tap with per-pixel weight rows.
    ``mv_q`` (B, h/n, w/n, 2) (y, x) in units of 1/2**frac_bits pel."""
    wtab = _table(taps, planes.device)                        # (F, K)
    ntap = wtab.shape[1]
    b, nf, hp, wp = planes.shape
    dy = _rep(mv_q[..., 0], n)                                # (B, h, w)
    dx = _rep(mv_q[..., 1], n)
    mask = (1 << frac_bits) - 1
    fy, fx = dy & mask, dx & mask
    rows = (torch.arange(h, device=planes.device).reshape(1, h, 1)
            + (dy >> frac_bits) + pad).to(torch.int64)
    cols = (torch.arange(w, device=planes.device).reshape(1, 1, w)
            + (dx >> frac_bits) + pad).to(torch.int64)
    base = (torch.arange(b, device=planes.device).reshape(b, 1, 1) * nf
            + fx) * hp
    flat = planes.reshape(-1)
    acc = torch.zeros((b, h, w), dtype=I32, device=planes.device)
    for j in range(ntap):
        g = flat[((base + rows + (j - ntap // 2 + 1)) * wp + cols)]
        acc = acc + wtab[:, j][fy] * g
    return torch.clamp(((acc >> 6) + 32) >> 6, 0, 255)


def _mc_luma_qpel(hplanes, mv_q, *, pad, h, w, n=32):
    """Luma MC at quarter-pel MVs on an (h/n, w/n) MV grid (n=32 per
    CTB, 16 for the partitioned motion field)."""
    return _mc_qpel(hplanes, mv_q, pad=pad, h=h, w=w, n=n, frac_bits=2,
                    taps="ltaps")


def _mc_chroma_qpel(cplanes, mv_q, *, pad, hc, wc, n=16):
    """Chroma MC: the luma quarter-pel value lands on the eighth-chroma
    grid; ``n`` is the chroma block size of one MV."""
    return _mc_qpel(cplanes, mv_q, pad=pad, h=hc, w=wc, n=n, frac_bits=3,
                    taps="ctaps")


def _block_sad(cur: torch.Tensor, pred: torch.Tensor, n: int) -> torch.Tensor:
    b, h, w = cur.shape
    return (cur - pred).abs().reshape(b, h // n, n, w // n, n).sum((2, 4)).to(I32)


_NEIGH = tuple((dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
               if (dy, dx) != (0, 0))


def _integer_search(cur, refp, *, search, pad, lam=2, n=32):
    """Integer ME per nxn block over every offset within ``search``:
    (B, H, W) -> ((B, H/n, W/n, 2) MVs in whole pels, their costs). The
    first minimum in the reference's order ((0, 0), then raster) wins."""
    b, h, w = cur.shape
    dev = cur.device
    span = 2 * search + 1
    # SADs one row of offsets (fixed dy, every dx) at a time
    costs = []
    cur5 = cur.reshape(b, h, 1, w)
    dxs = torch.arange(-search, search + 1, device=dev)
    for dy in range(-search, search + 1):
        band = refp[:, pad + dy:pad + dy + h]                 # (B, h, Wp)
        win = band.unfold(-1, w, 1)[:, :, pad - search:pad + search + 1]
        sad = (cur5 - win).abs().reshape(b, h // n, n, span, w // n, n)
        sad = sad.sum((2, 5)).permute(2, 0, 1, 3)             # (span, B, R, C)
        pen = (lam * 4 * (abs(dy) + dxs.abs())).to(I32).reshape(span, 1, 1, 1)
        costs.append(sad.to(I32) + pen)
    center = search * span + search
    order = [center] + [i for i in range(span * span) if i != center]
    costs = torch.cat(costs)[torch.tensor(order, device=dev)]
    offs = torch.tensor([(i // span - search, i % span - search) for i in order],
                        dtype=I32, device=dev)
    return offs[_first_argmin(costs)], costs.min(0).values


def _subpel_refine(cur, hplanes, mv_int, int_cost, *, pad, lam=2, n=32):
    """Half- then quarter-pel refinement through the real interpolation:
    each step tries the 8 neighbours in order, a candidate replacing the
    best only when strictly better. Returns quarter-pel MVs and costs."""
    h, w = cur.shape[-2:]

    def refine(base_q, base_cost, step_q):
        best_cost, best_mv = base_cost, base_q
        for dy, dx in _NEIGH:
            cand = base_q + torch.tensor([dy * step_q, dx * step_q], dtype=I32,
                                         device=cur.device)
            pred = _mc_luma_qpel(hplanes, cand, pad=pad, h=h, w=w, n=n)
            cost = _block_sad(cur, pred, n) + lam * cand.abs().sum(-1).to(I32)
            better = cost < best_cost
            best_cost = torch.where(better, cost, best_cost)
            best_mv = torch.where(better[..., None], cand, best_mv)
        return best_mv, best_cost

    mv_q, cost_q = refine(mv_int * 4, int_cost, 2)
    return refine(mv_q, cost_q, 1)


def _p_ctb_search(cur, refp, hplanes, *, search, pad, lam=2, n=32):
    """Integer ME per nxn block, then sub-pel refinement: (B, H, W) ->
    ((B, H/n, W/n, 2) MVs in quarter pels, their costs)."""
    mv, cost = _integer_search(cur, refp, search=search, pad=pad, lam=lam, n=n)
    return _subpel_refine(cur, hplanes, mv, cost, pad=pad, lam=lam, n=n)


def to_blocks(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(B, H, W) -> (B, H/n, W/n, n, n)."""
    b, h, w = plane.shape
    return plane.reshape(b, h // n, n, w // n, n).permute(0, 1, 3, 2, 4)


def from_blocks(blk: torch.Tensor, n: int) -> torch.Tensor:
    b, r, c = blk.shape[:3]
    return blk.permute(0, 1, 3, 2, 4).reshape(b, r * n, c * n)


def _p_residuals_and_recon(y, u, v, cur, hplanes, mv_map, part, qp, qpc,
                           pad, search, ref_u, ref_v, partitions=True):
    """MC + both residual codings + the decision-consistent recon."""
    h, w = cur.shape[-2:]
    pred_y = _mc_luma_qpel(hplanes, mv_map, pad=pad, h=h, w=w, n=16)
    cpad = search // 2 + 6
    hc, wc = u.shape[-2:]

    def chroma_pred(ref):
        planes = _hfiltered_planes(
            edge_pad(ref.to(I32), cpad, cpad, cpad, cpad), _CTAPS)
        return _mc_chroma_qpel(planes, mv_map, pad=cpad, hc=hc, wc=wc, n=8)

    pred_u, pred_v = chroma_pred(ref_u), chroma_pred(ref_v)
    cu, cv = u.to(I32), v.to(I32)
    ly32, ry32 = _code_blocks(to_blocks(cur, 32), to_blocks(pred_y, 32), qp, 5)
    lu16, ru16 = _code_blocks(to_blocks(cu, 16), to_blocks(pred_u, 16), qpc, 4)
    lv16, rv16 = _code_blocks(to_blocks(cv, 16), to_blocks(pred_v, 16), qpc, 4)
    if not partitions:
        # single-MV path: the sub-TU codings would never be read
        return ((ly32, lu16, lv16), None, part, mv_map,
                (from_blocks(ry32, 32).to(torch.uint8),
                 from_blocks(ru16, 16).to(torch.uint8),
                 from_blocks(rv16, 16).to(torch.uint8)))
    ly16, ry16 = _code_blocks(to_blocks(cur, 16), to_blocks(pred_y, 16), qp, 4)
    lu8, ru8 = _code_blocks(to_blocks(cu, 8), to_blocks(pred_u, 8), qpc, 3)
    lv8, rv8 = _code_blocks(to_blocks(cv, 8), to_blocks(pred_v, 8), qpc, 3)

    # recon consistent with the per-CTB transform choice
    def select(plane32, plane16, cells_per_ctb):
        mask = _rep(part == PART_2Nx2N, cells_per_ctb)
        return torch.where(mask, plane32, plane16)

    ry = select(from_blocks(ry32, 32), from_blocks(ry16, 16), 32)
    ru = select(from_blocks(ru16, 16), from_blocks(ru8, 8), 16)
    rv = select(from_blocks(rv16, 16), from_blocks(rv8, 8), 16)
    return ((ly32, lu16, lv16), (ly16, lu8, lv8), part, mv_map,
            (ry.to(torch.uint8), ru.to(torch.uint8), rv.to(torch.uint8)))


def _first_argmin(costs: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along dim 0 (``jnp.argmin``'s tie
    order, on every device)."""
    k = torch.arange(costs.shape[0], device=costs.device).reshape(
        (-1,) + (1,) * (costs.dim() - 1))
    hit = costs == costs.min(0).values
    return torch.where(hit, k, costs.shape[0]).min(0).values


def encode_p_frame_dsp(y, u, v, ref_y, ref_u, ref_v, qp, *, search: int = 16,
                       partitions: bool = True, deblock: bool = False):
    """A batch of P frames, each against its own previous reconstruction:
    y (B, H, W), u/v (B, H/2, W/2) uint8, qp (B,) int32. Every CTB is
    inter; its motion field is 2Nx2N (one MV), or with ``partitions``
    2NxN or Nx2N (two MVs) where that costs less. Returns per-CTB
    partition codes, the 16-cell MV map, both residual codings (TU32 +
    chroma 16 for 2Nx2N; four TU16 + 8x8 chroma sub-TUs for two-part
    CTBs, None without ``partitions``) and the recon consistent with the
    decision (in-loop deblocked per spec 8.7.2 when ``deblock``)."""
    qp = torch.as_tensor(qp, dtype=I32, device=y.device).reshape(-1)
    qpc = chroma_qp_traced(qp)
    # luma pad: integer reach + 1 refinement pel + 4-tap reach + the
    # 4-sample roll-wrap contamination ring of the horizontal filters
    pad = search + 8
    b, h, w = y.shape
    rr, cc = h // 32, w // 32
    cur = y.to(I32)
    refp = edge_pad(ref_y.to(I32), pad, pad, pad, pad)
    hplanes = _hfiltered_planes(refp, _LTAPS)
    mv32, sad32 = _p_ctb_search(cur, refp, hplanes, search=search, pad=pad,
                                n=32)
    if not partitions:
        part = torch.zeros((b, rr, cc), dtype=I32, device=y.device)
        out = _p_residuals_and_recon(
            y, u, v, cur, hplanes, _rep(mv32, 2), part, qp, qpc, pad, search,
            ref_u, ref_v, partitions=False)
        return _deblock_p(out, qp, qpc) if deblock else out
    mv16, _ = _p_ctb_search(cur, refp, hplanes, search=search, pad=pad, n=16)

    # partition decision: each half of a two-part CTB shares ONE MV, one
    # of its two refined 16-cell MVs, each evaluated exactly
    def sad16_under(mv_cells):
        pred = _mc_luma_qpel(hplanes, mv_cells, pad=pad, h=h, w=w, n=16)
        return (cur - pred).abs().reshape(b, rr, 2, 16, cc, 2, 16).sum(
            (3, 6)).to(I32)

    m = mv16.reshape(b, rr, 2, cc, 2, 2)              # (B, R, ry, C, rx, yx)

    def half_costs(horizontal):
        if horizontal:      # halves are cell rows
            cand_a, cand_b = m[:, :, :, :, 0], m[:, :, :, :, 1]

            def expand(cm):                           # (B, R, ry, C, 2)
                return cm.reshape(b, rr * 2, cc, 2).repeat_interleave(2, 2)
        else:               # halves are cell columns
            mt = m.permute(0, 1, 4, 3, 2, 5)          # (B, R, rx, C, ry, yx)
            cand_a, cand_b = mt[:, :, :, :, 0], mt[:, :, :, :, 1]

            def expand(cm):                           # (B, R, rx, C, 2)
                return cm.permute(0, 1, 3, 2, 4).reshape(
                    b, rr, cc * 2, 2).repeat_interleave(2, 1)
        s_a = sad16_under(expand(cand_a))             # (B, R, ry, C, rx)
        s_b = sad16_under(expand(cand_b))
        if horizontal:
            ha, hb = s_a.sum(4), s_b.sum(4)           # (B, R, ry, C)
        else:
            ha = s_a.sum(2).permute(0, 1, 3, 2)       # (B, R, rx, C)
            hb = s_b.sum(2).permute(0, 1, 3, 2)
        mv_best = torch.where((hb < ha)[..., None], cand_b, cand_a)
        return torch.minimum(ha, hb).sum(2).to(I32), mv_best

    c_2nxn, mv_h = half_costs(True)
    c_nx2n, mv_v = half_costs(False)
    pen = (_PART_PENALTY * _one_shl(torch.clamp(qp // 6, 0, 8))).reshape(b, 1, 1)
    part = _first_argmin(torch.stack([sad32, c_2nxn + pen, c_nx2n + pen])
                         ).to(I32)

    # the unified 16-cell MV map realizes every partition
    mvh_cells = mv_h.reshape(b, rr * 2, cc, 2).repeat_interleave(2, 2)
    mvv_cells = mv_v.permute(0, 1, 3, 2, 4).reshape(
        b, rr, cc * 2, 2).repeat_interleave(2, 1)
    part_cells = _rep(part, 2)[..., None]
    mv_map = torch.where(part_cells == PART_2Nx2N, _rep(mv32, 2),
                         torch.where(part_cells == PART_2NxN, mvh_cells,
                                     mvv_cells))
    out = _p_residuals_and_recon(y, u, v, cur, hplanes, mv_map, part, qp, qpc,
                                 pad, search, ref_u, ref_v)
    return _deblock_p(out, qp, qpc) if deblock else out


def _deblock_p(out, qp, qpc):
    """Spec 8.7.2 on a batch of P recons. Luma-TB cbf drives bS 1; the TU
    grid is TU32 in 2Nx2N CTBs and TU16 inside partitioned ones. Chroma
    needs bS 2 (intra), never on P pictures, so only luma is filtered."""
    lv32, lv16, part, mv_map, (ry, ru, rv) = out
    cell_cbf = _rep((lv32[0] != 0).any(-1).any(-1), 2)      # (B, 2R, 2C)
    if lv16 is not None:
        cbf16 = (lv16[0] != 0).any(-1).any(-1)
        cell_cbf = torch.where(_rep(part, 2) == PART_2Nx2N, cell_cbf, cbf16)
    bs_v, bs_h = dbk.p_bs(part, cell_cbf, mv_map)
    dy, du, dv = dbk.deblock_picture(ry, ru, rv, qp=qp, qpc=qpc, bs_v=bs_v,
                                     bs_h=bs_h, chroma=False)
    return (lv32, lv16, part, mv_map,
            (dy.to(torch.uint8), du.to(torch.uint8), dv.to(torch.uint8)))


def encode_chain_dsp(y, u, v, search, qp_i, qp_p, partitions=False,
                     deblock=False, rc=None):
    """A batch of I + P chains: y (B, T, H, W), u/v (B, T, H/2, W/2)
    padded uint8 planes; frame 0 intra, frames 1.. inter against the
    running reconstruction. ``qp_i`` (B,), ``qp_p`` (B, T-1) (or
    anything that broadcasts to it) int32.

    ``rc`` (optional {"budget": bytes/frame, "alpha": bytes per proxy
    unit}, shared by the batch) enables the device's in-chain rate
    adaptation: each chain carries a float32 byte balance fed by the
    bits proxy, and each P frame's QP moves trunc(balance/(3*budget)) in
    [-1, +8] relative to plan, clipped to 10-51 (alpha 0 disables it).

    Returns ``((intra levels, intra recon), (p32, p16, parts, mvs,
    precons))`` with the P outputs stacked on dim 1 (None when T == 1;
    p16 None without ``partitions``), plus with ``rc`` a third element
    {"qp_eff": (B, T-1) int32, "cost": (B, T) float32}.
    """
    dev = y.device
    b, t = y.shape[:2]
    qp_i = torch.as_tensor(qp_i, dtype=I32, device=dev).reshape(-1)
    qp_p = torch.as_tensor(qp_p, dtype=I32, device=dev)
    qp_p = torch.broadcast_to(qp_p if qp_p.dim() == 2 else qp_p.reshape(1, -1),
                              (b, max(t - 1, 1)))
    (li, lui, lvi), rec_i = encode_frame_dsp(y[:, 0], u[:, 0], v[:, 0], qp_i,
                                             deblock=deblock)
    recon = rec_i
    if rc is not None:
        budget = torch.clamp(torch.as_tensor(rc["budget"], dtype=torch.float32,
                                             device=dev), min=1.0)
        alpha = torch.as_tensor(rc["alpha"], dtype=torch.float32, device=dev)
        costs = [cost_proxy(li, lui, lvi, batch_ndim=1)]
        bal = torch.zeros((b,), dtype=torch.float32, device=dev)
        qp_eff = []
    outs = []
    for k in range(1, t):
        qpf = qp_p[:, k - 1]
        if rc is not None:
            adj = torch.clamp(torch.trunc(bal / (3.0 * budget)),
                              -1.0, 8.0).to(I32)
            qpf = torch.clamp(qpf + adj, 10, 51)
        o = encode_p_frame_dsp(y[:, k], u[:, k], v[:, k], *recon, qpf,
                               search=search, partitions=partitions,
                               deblock=deblock)
        recon = o[4]
        outs.append(o)
        if rc is not None:
            cost = cost_proxy(*o[0], batch_ndim=1)
            # anti-windup: credit bottoms at 3 frames of budget, debt tops
            # at what +8 QP can repay; the I frame is not charged
            step = torch.where(alpha > 0, cost * alpha - budget,
                               torch.zeros_like(cost))
            bal = torch.minimum(torch.maximum(bal + step, -3.0 * budget),
                                30.0 * budget)
            costs.append(cost)
            qp_eff.append(qpf)

    def stack(items):
        return None if items[0] is None else torch.stack(items, 1)

    if outs:
        p32 = tuple(stack([o[0][i] for o in outs]) for i in range(3))
        p16 = (None if outs[0][1] is None else
               tuple(stack([o[1][i] for o in outs]) for i in range(3)))
        parts = stack([o[2] for o in outs])
        mvs = stack([o[3] for o in outs])
        precons = tuple(stack([o[4][i] for o in outs]) for i in range(3))
    else:
        p32 = p16 = parts = mvs = precons = None
    base = (((li, lui, lvi), rec_i), (p32, p16, parts, mvs, precons))
    if rc is None:
        return base
    return base + ({"qp_eff": (torch.stack(qp_eff, 1) if qp_eff else
                               torch.zeros((b, 0), dtype=I32, device=dev)),
                    "cost": torch.stack(costs, 1)},)
