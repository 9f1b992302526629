"""HEVC residual_coding() writer (H.265 7.3.8.11 + 9.3.4.2/9.3.3.13).

Covers the TB shapes the slice writers emit: 32x32/16x16 luma, 16x16
chroma, and 8x8 chroma (the forced sub-TUs of non-2Nx2N inter CUs,
pslice.write_ctu_inter_2part). Diagonal scan throughout (the
mode-dependent horizontal/vertical scans only apply to 4x4 and
luma-8x8 TBs, which this stream shape never codes), no transform-skip,
no sign-data-hiding.

NOTE: the C port (native/hevc_cabac.c) covers the 2Nx2N shapes only
(32 luma / 16 chroma); two-part CUs entropy-code through this Python
reference until the C coder grows the sub-TU paths.

The coefficient-group machinery: the TB is scanned as 4x4 coefficient
groups in up-right diagonal order; coding runs backwards from the last
significant coefficient — last-position prefix/suffix, then per CG a
coded_sub_block_flag, significance flags with the pattern-based
context derivation, capped greater1/greater2 flags, bypass signs and
Golomb-Rice remainders with parameter adaptation.

This is the Python reference implementation; tests oracle it against
libavcodec end-to-end (tests/test_hevc.py) and the C port in
native/hevc_cabac.c must stay bit-exact with it.
"""

from __future__ import annotations

import numpy as np

from vlog_tpu_torch.codecs.hevc.cabac import CabacEncoder
from vlog_tpu_torch.codecs.hevc.tables import (
    CTX_OFF,
    DIAG_SCAN_4x4,
    DIAG_SCAN_8x8,
)

_LAST_X = CTX_OFF["LAST_X_PREFIX"][0]
_LAST_Y = CTX_OFF["LAST_Y_PREFIX"][0]
_SIG_CG = CTX_OFF["SIG_CG_FLAG"][0]
_SIG = CTX_OFF["SIG_COEFF"][0]
_G1 = CTX_OFF["GREATER1"][0]
_G2 = CTX_OFF["GREATER2"][0]

# last_sig_coeff_{x,y} binarization (H.265 9.3.3.12 table)
_GROUP_IDX = [0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
              8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9]
_MIN_IN_GROUP = [0, 1, 2, 3, 4, 6, 8, 12, 16, 24]


# up-right diagonal over a 2x2 CG grid (8x8 TBs)
DIAG_SCAN_2x2 = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _cg_scan(n_cg: int):
    if n_cg == 8:
        return DIAG_SCAN_8x8
    if n_cg == 4:
        return DIAG_SCAN_4x4
    return DIAG_SCAN_2x2


def _scan_positions(log2_size: int) -> list[tuple[int, int]]:
    """Forward diagonal scan of the whole TB: CG-major, 4x4 inside."""
    n_cg = 1 << (log2_size - 2)
    out = []
    for cx, cy in _cg_scan(n_cg)[: n_cg * n_cg]:
        for ix, iy in DIAG_SCAN_4x4:
            out.append((cx * 4 + ix, cy * 4 + iy))
    return out


def _write_last_prefix(c: CabacEncoder, group: int, cmax: int,
                       base: int, offset: int, shift: int) -> None:
    for b in range(group):
        c.encode_bin(base + offset + (b >> shift), 1)
    if group < cmax:
        c.encode_bin(base + offset + (group >> shift), 0)


def _write_remaining(c: CabacEncoder, value: int, rice: int) -> None:
    """coeff_abs_level_remaining: Golomb-Rice with EGk escape
    (inverse of H.265 9.3.3.13)."""
    if value < (3 << rice):
        for _ in range(value >> rice):
            c.encode_bypass(1)
        c.encode_bypass(0)
        if rice:
            c.encode_bypass_bits(value & ((1 << rice) - 1), rice)
    else:
        length = rice
        value -= 3 << rice
        while value >= (1 << length):
            value -= 1 << length
            length += 1
        for _ in range(3 + length - rice):   # unary prefix: p ones + 0
            c.encode_bypass(1)
        c.encode_bypass(0)
        if length:
            c.encode_bypass_bits(value, length)


def _sig_ctx(x: int, y: int, c_idx: int, prev_csbf: int,
             chroma8: bool = False) -> int:
    """sig_coeff_flag ctxIdxInc (9.3.4.2.5): luma 16/32, chroma 16 and
    chroma 8x8 (``chroma8`` — the inter sub-TU case; 8x8 luma and the
    4x4 map cases stay outside this stream shape)."""
    if x == 0 and y == 0:
        return 0 if c_idx == 0 else 27
    xp, yp = x & 3, y & 3
    if prev_csbf == 0:
        s = 2 if xp + yp == 0 else (1 if xp + yp < 3 else 0)
    elif prev_csbf == 1:
        s = 2 if yp == 0 else (1 if yp == 1 else 0)
    elif prev_csbf == 2:
        s = 2 if xp == 0 else (1 if xp == 1 else 0)
    else:
        s = 2
    if c_idx == 0:
        if (x >> 2) or (y >> 2):    # not the first coefficient group
            s += 3
        return s + 21               # luma nTbS {16,32}
    return 27 + s + (9 if chroma8 else 12)


def write_residual(c: CabacEncoder, levels: np.ndarray, *,
                   log2_size: int, c_idx: int) -> None:
    """Emit residual_coding() for one TB. ``levels`` raster (N, N) ints,
    at least one nonzero."""
    n = 1 << log2_size
    n_cg = n >> 2
    scan = _scan_positions(log2_size)
    lv = np.asarray(levels)

    last_scan = max(i for i, (x, y) in enumerate(scan) if lv[y, x])
    last_x, last_y = scan[last_scan]

    # ---- last position (x prefix, y prefix, x suffix, y suffix)
    cmax = (log2_size << 1) - 1
    if c_idx == 0:
        offset, shift = 3 * (log2_size - 2) + ((log2_size - 1) >> 2), \
            (log2_size + 1) >> 2
    else:
        offset, shift = 15, log2_size - 2
    gx, gy = _GROUP_IDX[last_x], _GROUP_IDX[last_y]
    _write_last_prefix(c, gx, cmax, _LAST_X, offset, shift)
    _write_last_prefix(c, gy, cmax, _LAST_Y, offset, shift)
    if gx > 3:
        c.encode_bypass_bits(last_x - _MIN_IN_GROUP[gx], (gx >> 1) - 1)
    if gy > 3:
        c.encode_bypass_bits(last_y - _MIN_IN_GROUP[gy], (gy >> 1) - 1)

    # ---- per-CG coefficient data, back from the last CG
    cg_scan = _cg_scan(n_cg)[: n_cg * n_cg]
    csbf = np.zeros((n_cg, n_cg), dtype=bool)
    for cyy in range(n_cg):
        for cxx in range(n_cg):
            csbf[cyy, cxx] = bool(
                np.any(lv[cyy * 4:cyy * 4 + 4, cxx * 4:cxx * 4 + 4]))

    last_cg = last_scan >> 4
    greater1_ctx = 1            # carries across CGs (HM's c1)
    first_cg_done = False
    for ci in range(last_cg, -1, -1):
        cx, cy = cg_scan[ci]
        coded = bool(csbf[cy, cx])
        explicit = ci != last_cg and ci != 0
        right = cx + 1 < n_cg and bool(csbf[cy, cx + 1])
        below = cy + 1 < n_cg and bool(csbf[cy + 1, cx])
        if explicit:
            c.encode_bin(
                _SIG_CG + (2 if c_idx else 0) + (1 if right or below else 0),
                int(coded))
            if not coded:
                continue
        # CG0 (and the last CG) have csbf *inferred* 1: an all-zero CG0
        # still codes its 16 zero significance flags
        prev_csbf = int(right) + 2 * int(below)

        # significance flags, reverse scan; last coeff inferred
        start = (last_scan % 16) - 1 if ci == last_cg else 15
        infer_dc = explicit             # last CG is never explicit
        sigs = []                       # coding order (reverse scan)
        if ci == last_cg:
            sigs.append(scan[last_scan])
        for j in range(start, -1, -1):
            x, y = scan[(ci << 4) + j]
            significant = bool(lv[y, x])
            if j == 0 and infer_dc and not sigs:
                # every earlier flag in this CG was zero, and the coded
                # csbf==1 promises a nonzero -> DC significance inferred
                sigs.append((x, y))
                continue
            c.encode_bin(_SIG + _sig_ctx(x, y, c_idx, prev_csbf,
                                         chroma8=(log2_size == 3)),
                         int(significant))
            if significant:
                sigs.append((x, y))

        if not sigs:                    # all-zero CG0
            continue
        # greater1 (<=8), greater2 (1), signs, remainders
        ctx_set = (2 if ci > 0 and c_idx == 0 else 0)
        if first_cg_done and greater1_ctx == 0:
            ctx_set += 1
        first_cg_done = True
        greater1_ctx = 1
        g1_flags = []
        g2_pos = None
        for k, (x, y) in enumerate(sigs[:8]):
            flag = int(abs(int(lv[y, x])) > 1)
            base = _G1 + (16 if c_idx else 0)
            c.encode_bin(base + ctx_set * 4 + min(greater1_ctx, 3), flag)
            g1_flags.append(flag)
            if flag:
                if g2_pos is None:
                    g2_pos = k
                greater1_ctx = 0
            elif 0 < greater1_ctx < 3:
                greater1_ctx += 1
        g2_flag = 0
        if g2_pos is not None:
            x, y = sigs[g2_pos]
            g2_flag = int(abs(int(lv[y, x])) > 2)
            c.encode_bin(_G2 + (4 + ctx_set if c_idx else ctx_set), g2_flag)
        for x, y in sigs:               # no sign hiding
            c.encode_bypass(1 if lv[y, x] < 0 else 0)
        rice = 0
        for k, (x, y) in enumerate(sigs):
            absl = abs(int(lv[y, x]))
            if k < 8:
                if g1_flags[k] == 0:
                    continue            # level is exactly 1
                if k == g2_pos:
                    if not g2_flag:
                        continue        # level is exactly 2
                    base_level = 3
                else:
                    base_level = 2
            else:
                base_level = 1
            _write_remaining(c, absl - base_level, rice)
            if absl > (3 << rice):
                rice = min(rice + 1, 4)
