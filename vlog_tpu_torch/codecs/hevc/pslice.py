"""HEVC P-slice syntax: TRAIL pictures with integer-MV inter CTBs.

Extends the all-intra envelope (slice.py) with single-reference P
slices: every CTB is either an inter 2Nx2N CU with an explicitly coded
quarter-pel MV (AMVP, mvp_l0_flag=0, no merge/skip — avoids the merge
candidate machinery entirely at a cost of a few bins per CTB) or falls
back to the intra mode-26 CU when motion fails. The device DSP
(core.py) interpolates with the spec 8-tap luma / 4-tap chroma
filters — the HEVC analog of the H.264 chain design.

The AMVP predictor (8.5.3.2.6) is computed by an entropy-time state
machine over the CTB grid, mirroring what any decoder derives:
candidate A = the left CU's MV (below-left is never decoded yet at CTB
granularity), candidate B = first of above-right/above/above-left,
pruned and zero-filled. All PUs share one reference picture (the
previous frame, RPS delta=1), so no MV scaling is ever needed.

Oracle: tests/test_hevc.py decodes I+P chains with libavcodec and
asserts byte-exact reconstruction.
"""

from __future__ import annotations

import numpy as np

from vlog_tpu_torch.codecs.hevc.cabac import CabacEncoder
from vlog_tpu_torch.codecs.hevc.residual import write_residual
from vlog_tpu_torch.codecs.hevc.syntax import CTB, NalUnit
from vlog_tpu_torch.codecs.hevc.tables import CTX_OFF
from vlog_tpu_torch.media.bitstream import BitWriter

NAL_TRAIL_R = 1

_SKIP = CTX_OFF["SKIP"][0]
_PRED_MODE = CTX_OFF["PRED_MODE"][0]
_PART = CTX_OFF["PART_MODE"][0]
_MERGE = CTX_OFF["MERGE_FLAG"][0]
_MVP = CTX_OFF["MVP_LX"][0]
_ROOT_CBF = CTX_OFF["NO_RESIDUAL"][0]
# mvd_coding contexts: greater0 at the block base, greater1 at +3
# (both measured from the hls_mvd_coding disassembly)
_MVD_G0 = CTX_OFF["MVD_GREATER"][0]
_MVD_G1 = CTX_OFF["MVD_GREATER"][0] + 3
_PREV = CTX_OFF["PREV_INTRA_LUMA"][0]
_CHROMA = CTX_OFF["INTRA_CHROMA_PRED"][0]
_CBF_LUMA = CTX_OFF["CBF_LUMA"][0]
_CBF_CHROMA = CTX_OFF["CBF_CB_CR"][0]


def p_slice_header_bits(slice_qp: int, poc_lsb: int) -> BitWriter:
    """P slice header for our stream shape (7.3.6.1): one negative ref
    at delta 1, no SAO/deblock/temporal-MVP, merge depth 1."""
    w = BitWriter()
    w.write_bit(1)            # first_slice_segment_in_pic_flag
    w.write_ue(0)             # slice_pic_parameter_set_id
    w.write_ue(1)             # slice_type = P
    w.write_bits(poc_lsb & 0xFF, 8)   # slice_pic_order_cnt_lsb
    w.write_bit(0)            # short_term_ref_pic_set_sps_flag
    w.write_ue(1)             # num_negative_pics
    w.write_ue(0)             # num_positive_pics
    w.write_ue(0)             # delta_poc_s0_minus1 (prev picture)
    w.write_bit(1)            # used_by_curr_pic_s0_flag
    w.write_bit(0)            # num_ref_idx_active_override_flag (PPS: 1)
    w.write_ue(4)             # five_minus_max_num_merge_cand -> 1
    w.write_se(slice_qp - 26)  # slice_qp_delta
    w.write_bit(1)            # alignment_bit_equal_to_one
    w.byte_align(0)
    return w


def _has(levels) -> bool:
    return levels is not None and np.any(levels)


class MvpGrid:
    """AMVP over a 16x16-cell grid (encoder-side mirror of 8.5.3.2.6
    for our shape: CTB-sized 2Nx2N PUs or two-half 2NxN/Nx2N PUs).
    Tracks (is_inter, mv) per coded 16-cell; neighbor positions follow
    the spec's PU-bounding-box rules."""

    def __init__(self, rows: int, cols: int) -> None:
        self.rows, self.cols = rows * 2, cols * 2   # 16-cell grid
        self.inter = np.zeros((self.rows, self.cols), bool)
        self._coded = np.zeros((self.rows, self.cols), bool)
        self.mv = np.zeros((self.rows, self.cols, 2), np.int32)  # (x, y)

    def _cand(self, r: int, c: int):
        if 0 <= r < self.rows and 0 <= c < self.cols \
                and self._coded[r, c] and self.inter[r, c]:
            return tuple(int(v) for v in self.mv[r, c])
        return None

    def _predict_bbox(self, y0, y1, x0, x1) -> tuple:
        """mvp candidate 0 for a PU covering 16-cells rows y0..y1, cols
        x0..x1. Only the first list entry matters (mvp_l0_flag is always
        0): A1 if available, else the first of B0/B1/B2, else zero (the
        spec's A==B pruning and zero-fill only reorder entry 1).

        The second PU of a two-part CU may predict from the first
        (verified against libavcodec: the merge-style same-CU exclusion
        does NOT apply to AMVP), so PU0's cells — recorded before PU1
        is coded — are legitimate candidates here.

        A0 (below-left) precedes A1 in the spec scan; it is decoded
        only for the TOP PU of a 2NxN CU (where below-left is the left
        CTB's bottom half) — _cand's coded-gate makes probing it safe
        everywhere."""
        a = self._cand(y1 + 1, x0 - 1)           # A0 (below-left)
        if a is None:
            a = self._cand(y1, x0 - 1)           # A1
        if a is not None:
            return a
        for rc in ((y0 - 1, x1 + 1), (y0 - 1, x1),
                   (y0 - 1, x0 - 1)):            # B0, B1, B2
            b = self._cand(*rc)
            if b is not None:
                return b
        return (0, 0)

    def _pu_cells(self, r, c, vertical, pu):
        y0, x0 = 2 * r, 2 * c
        if vertical:                             # Nx2N: left/right 16x32
            return y0, y0 + 1, x0 + pu, x0 + pu
        return y0 + pu, y0 + pu, x0, x0 + 1      # 2NxN: top/bottom 32x16

    def predictor(self, r: int, c: int) -> tuple[int, int]:
        return self._predict_bbox(2 * r, 2 * r + 1, 2 * c, 2 * c + 1)

    def predictor_2part(self, r, c, *, vertical, pu) -> tuple[int, int]:
        return self._predict_bbox(*self._pu_cells(r, c, vertical, pu))

    def _fill(self, y0, y1, x0, x1, inter, mv):
        self.inter[y0:y1 + 1, x0:x1 + 1] = inter
        self._coded[y0:y1 + 1, x0:x1 + 1] = True
        self.mv[y0:y1 + 1, x0:x1 + 1] = mv

    def record(self, r: int, c: int, *, inter: bool,
               mv: tuple[int, int] = (0, 0)) -> None:
        self._fill(2 * r, 2 * r + 1, 2 * c, 2 * c + 1, inter, mv)

    def record_2part(self, r, c, *, vertical, pu, mv) -> None:
        self._fill(*self._pu_cells(r, c, vertical, pu), True, mv)


def _write_mvd(c: CabacEncoder, dx: int, dy: int) -> None:
    """mvd_coding (7.3.8.9): greater0/1 context bins, EG1 remainder and
    sign in bypass. (dx, dy) in quarter-pel, bitstream order x then y."""
    comps = (dx, dy)
    g0 = [int(v != 0) for v in comps]
    g1 = [int(abs(v) > 1) for v in comps]
    c.encode_bin(_MVD_G0, g0[0])
    c.encode_bin(_MVD_G0, g0[1])
    if g0[0]:
        c.encode_bin(_MVD_G1, g1[0])
    if g0[1]:
        c.encode_bin(_MVD_G1, g1[1])
    for i, v in enumerate(comps):
        if not g0[i]:
            continue
        if g1[i]:
            rem = abs(v) - 2
            k = 1                               # EG1 bypass
            while rem >= (1 << k):
                c.encode_bypass(1)
                rem -= 1 << k
                k += 1
            c.encode_bypass(0)
            c.encode_bypass_bits(rem, k)
        c.encode_bypass(1 if v < 0 else 0)


class PSliceWriter:
    """Accumulates one P-slice's CABAC payload CTU by CTU.

    ``write_ctu_inter``: 2Nx2N inter CU with a quarter-pel MV
    ((y, x) DSP order — the bitstream's own resolution) and optional
    residual levels. ``write_ctu_intra``: the mode-26 intra CU, usable
    as fallback inside P slices.
    """

    def __init__(self, slice_qp: int, rows: int, cols: int) -> None:
        self.c = CabacEncoder(slice_qp, init_type=1)    # P initType
        self.grid = MvpGrid(rows, cols)

    def _common_p_prefix(self) -> None:
        # cu_skip_flag: never skipped; both neighbours are non-skip so
        # ctxInc is always 0
        self.c.encode_bin(_SKIP, 0)

    def write_ctu_inter_2part(self, r: int, col: int, *, vertical: bool,
                              mv0, mv1, luma_tus, cb_tus, cr_tus,
                              last_in_slice: bool) -> None:
        """Inter CU split into two PUs: 2NxN (``vertical=False``, top/
        bottom 32x16) or Nx2N (left/right 16x32). ``mv0``/``mv1`` are
        (y, x) quarter-pel for the first/second PU. Residuals arrive as
        four forced sub-TUs in z-order: ``luma_tus`` four 16x16 arrays
        (or None), ``cb_tus``/``cr_tus`` four 8x8 arrays (or None) —
        max_transform_hierarchy_depth_inter=0 with a non-2Nx2N part
        forces the transform split (7.4.9.8 interSplitFlag)."""
        c = self.c
        self._common_p_prefix()
        c.encode_bin(_PRED_MODE, 0)              # MODE_INTER
        # part_mode (9.3.3.7, inter at MIN cb size — our CTB == minCB):
        # 2NxN = '01'; Nx2N = '001' (the third bin distinguishes NxN)
        c.encode_bin(_PART, 0)
        c.encode_bin(_PART + 1, 0 if vertical else 1)
        if vertical:
            c.encode_bin(_PART + 2, 1)

        # PU0 then PU1; AMVP per PU over the half-CTB (16-grid) cells
        for pu, mv in ((0, mv0), (1, mv1)):
            c.encode_bin(_MERGE, 0)
            mvq = (int(mv[1]), int(mv[0]))       # bitstream (x, y)
            pmx, pmy = self.grid.predictor_2part(
                r, col, vertical=vertical, pu=pu)
            _write_mvd(c, mvq[0] - pmx, mvq[1] - pmy)
            c.encode_bin(_MVP, 0)
            self.grid.record_2part(r, col, vertical=vertical, pu=pu,
                                   mv=mvq)

        root = any(_has(t) for tus in (luma_tus, cb_tus, cr_tus)
                   for t in tus)
        c.encode_bin(_ROOT_CBF, int(root))
        if not root:
            c.encode_terminate(1 if last_in_slice else 0)
            return
        # transform_tree depth 0: parent chroma cbfs cover the 16x16
        # chroma; the split to four TU16s is inferred (interSplitFlag)
        p_cb = any(_has(t) for t in cb_tus)
        p_cr = any(_has(t) for t in cr_tus)
        c.encode_bin(_CBF_CHROMA, int(p_cb))     # trafoDepth 0 ctx
        c.encode_bin(_CBF_CHROMA, int(p_cr))
        for i in range(4):                       # z-order sub-TUs
            cbf_l = _has(luma_tus[i])
            cbf_cb = _has(cb_tus[i])
            cbf_cr = _has(cr_tus[i])
            if p_cb:
                c.encode_bin(_CBF_CHROMA + 1, int(cbf_cb))
            if p_cr:
                c.encode_bin(_CBF_CHROMA + 1, int(cbf_cr))
            c.encode_bin(_CBF_LUMA, int(cbf_l))  # trafoDepth 1 ctx
            if cbf_l:
                write_residual(c, luma_tus[i], log2_size=4, c_idx=0)
            if cbf_cb:
                write_residual(c, cb_tus[i], log2_size=3, c_idx=1)
            if cbf_cr:
                write_residual(c, cr_tus[i], log2_size=3, c_idx=2)
        c.encode_terminate(1 if last_in_slice else 0)

    def write_ctu_inter(self, r: int, col: int, mv_q: tuple[int, int],
                        luma, cb, cr, *, last_in_slice: bool) -> None:
        """mv_q = (y, x) QUARTER luma pels (DSP order)."""
        c = self.c
        self._common_p_prefix()
        c.encode_bin(_PRED_MODE, 0)              # MODE_INTER
        c.encode_bin(_PART, 1)                   # PART_2Nx2N
        c.encode_bin(_MERGE, 0)                  # explicit AMVP
        mvq = (int(mv_q[1]), int(mv_q[0]))       # bitstream (x, y)
        pmx, pmy = self.grid.predictor(r, col)
        _write_mvd(c, mvq[0] - pmx, mvq[1] - pmy)
        c.encode_bin(_MVP, 0)                    # mvp_l0_flag = cand 0
        self.grid.record(r, col, inter=True, mv=mvq)

        cbf_l, cbf_cb, cbf_cr = _has(luma), _has(cb), _has(cr)
        root = cbf_l or cbf_cb or cbf_cr
        c.encode_bin(_ROOT_CBF, int(root))       # rqt_root_cbf
        if not root:
            c.encode_terminate(1 if last_in_slice else 0)
            return
        # transform_tree depth 0 (no split): chroma cbfs, then luma cbf
        # — which is INFERRED 1 when both chroma are 0 (7.3.8.8)
        c.encode_bin(_CBF_CHROMA, int(cbf_cb))
        c.encode_bin(_CBF_CHROMA, int(cbf_cr))
        if cbf_cb or cbf_cr:
            c.encode_bin(_CBF_LUMA + 1, int(cbf_l))
        else:
            assert cbf_l, "rqt_root_cbf=1 with all-zero TBs"
        if cbf_l:
            write_residual(c, luma, log2_size=5, c_idx=0)
        if cbf_cb:
            write_residual(c, cb, log2_size=4, c_idx=1)
        if cbf_cr:
            write_residual(c, cr, log2_size=4, c_idx=2)
        c.encode_terminate(1 if last_in_slice else 0)

    def write_ctu_intra(self, r: int, col: int, luma, cb, cr, *,
                        last_in_slice: bool) -> None:
        """Intra fallback CU inside the P slice (mode 26, as slice.py)."""
        c = self.c
        self._common_p_prefix()
        c.encode_bin(_PRED_MODE, 1)              # MODE_INTRA
        c.encode_bin(_PART, 1)                   # 2Nx2N
        # MPM (8.4.2): candB is always DC (above PU leaves the CTB);
        # candA is 26 only when the LEFT CU exists and is itself intra
        # (inter neighbours contribute DC) — in P slices that depends on
        # per-CTB decisions, unlike the all-intra slice's static pattern:
        #   A=26, B=DC -> list {26, DC, planar} -> mpm_idx 0
        #   A=B=DC     -> list {planar, DC, 26} -> mpm_idx 2
        left_is_intra = (col > 0 and self.grid._coded[2 * r, 2 * col - 1]
                         and not self.grid.inter[2 * r, 2 * col - 1])
        prev_flag, mpm_idx = (1, 0) if left_is_intra else (1, 2)
        c.encode_bin(_PREV, prev_flag)
        if mpm_idx == 0:
            c.encode_bypass(0)
        else:
            c.encode_bypass(1)
            c.encode_bypass(mpm_idx - 1)
        c.encode_bin(_CHROMA, 0)                 # DM

        cbf_cb, cbf_cr, cbf_l = _has(cb), _has(cr), _has(luma)
        c.encode_bin(_CBF_CHROMA, int(cbf_cb))
        c.encode_bin(_CBF_CHROMA, int(cbf_cr))
        c.encode_bin(_CBF_LUMA + 1, int(cbf_l))
        if cbf_l:
            write_residual(c, luma, log2_size=5, c_idx=0)
        if cbf_cb:
            write_residual(c, cb, log2_size=4, c_idx=1)
        if cbf_cr:
            write_residual(c, cr, log2_size=4, c_idx=2)
        self.grid.record(r, col, inter=False)
        c.encode_terminate(1 if last_in_slice else 0)

    def payload(self) -> bytes:
        return self.c.getvalue()


def p_nal(slice_qp: int, poc_lsb: int, payload: bytes) -> NalUnit:
    hdr = p_slice_header_bits(slice_qp, poc_lsb)
    return NalUnit(NAL_TRAIL_R, hdr.getvalue() + payload)
