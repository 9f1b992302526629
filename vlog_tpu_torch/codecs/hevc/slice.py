"""HEVC slice-data writer: CTU/CU/TU syntax over the CABAC engine.

Stream shape (see syntax.py): every CTB is one 32x32 intra CU, part
2Nx2N, luma mode 26 (exact vertical), chroma DM, one 32x32 luma TU +
two 16x16 chroma TUs, SAO/deblocking off.  What remains per CTU is:
part_mode, the MPM-coded luma mode, the chroma DM bin, three cbf bits,
up to three residual_coding() blocks, and the end_of_slice terminate
bin (H.265 7.3.8.2-7.3.8.11).

Why mode 26 everywhere: with 32x32 TBs the spec applies *no* intra
boundary filtering and exact-vertical reads only the top reference
row, so reconstruction depends on the row above alone — that is what
lets encoder.py vectorize whole CTB rows on the device the same way the
H.264 core does (codecs/h264/encoder.py module docstring).  The MPM
derivation below exploits the same shape: the above neighbour is
always outside the current CTB (PUs are CTB-sized), so
candIntraPredModeB is always INTRA_DC (H.265 8.4.2).
"""

from __future__ import annotations

import numpy as np

from vlog_tpu_torch.codecs.hevc.cabac import CabacEncoder
from vlog_tpu_torch.codecs.hevc.residual import write_residual
from vlog_tpu_torch.codecs.hevc.tables import CTX_OFF

_PART = CTX_OFF["PART_MODE"][0]
_PREV = CTX_OFF["PREV_INTRA_LUMA"][0]
_CHROMA = CTX_OFF["INTRA_CHROMA_PRED"][0]
_CBF_LUMA = CTX_OFF["CBF_LUMA"][0]
_CBF_CHROMA = CTX_OFF["CBF_CB_CR"][0]

MODE_VERT = 26


def mpm_bins(col: int) -> tuple[int, int]:
    """(prev_intra_luma_pred_flag, mpm_idx) encoding luma mode 26.

    H.265 8.4.2 with our shape: candB = DC always (above PU leaves the
    CTB); candA = DC at column 0 (left unavailable) else 26.
      col 0:  A==B==DC (<2)  -> list {planar, DC, 26} -> mpm_idx 2
      col>0:  A=26, B=DC     -> list {26, DC, planar} -> mpm_idx 0
    """
    return (1, 2) if col == 0 else (1, 0)


class SliceWriter:
    """Accumulates one I-slice's CABAC payload CTU by CTU."""

    def __init__(self, slice_qp: int) -> None:
        self.c = CabacEncoder(slice_qp)

    def write_ctu(
        self,
        col: int,
        luma_levels: np.ndarray | None,
        cb_levels: np.ndarray | None,
        cr_levels: np.ndarray | None,
        *,
        last_in_slice: bool,
    ) -> None:
        """One CTB: 32x32 intra CU.  ``*_levels`` are quantized
        coefficient arrays in raster order (32x32 luma, 16x16 chroma),
        or None / all-zero for cbf=0."""
        c = self.c

        def has(levels):
            return levels is not None and np.any(levels)

        # coding_quadtree: CTB==MinCb -> no split_cu_flag
        # coding_unit: I slice -> no transquant bypass/skip/pred_mode
        c.encode_bin(_PART, 1)                      # part_mode = 2Nx2N
        prev_flag, mpm_idx = mpm_bins(col)
        c.encode_bin(_PREV, prev_flag)
        if mpm_idx == 0:
            c.encode_bypass(0)
        else:                                       # TR cMax=2
            c.encode_bypass(1)
            c.encode_bypass(mpm_idx - 1)
        c.encode_bin(_CHROMA, 0)                    # chroma mode = DM

        # transform_tree depth 0 (split inferred 0, MaxTrafoDepth=0)
        cbf_cb, cbf_cr, cbf_luma = has(cb_levels), has(cr_levels), has(luma_levels)
        c.encode_bin(_CBF_CHROMA, int(cbf_cb))
        c.encode_bin(_CBF_CHROMA, int(cbf_cr))
        c.encode_bin(_CBF_LUMA + 1, int(cbf_luma))  # ctx 1: trafoDepth==0
        if cbf_luma:
            write_residual(c, luma_levels, log2_size=5, c_idx=0)
        if cbf_cb:
            write_residual(c, cb_levels, log2_size=4, c_idx=1)
        if cbf_cr:
            write_residual(c, cr_levels, log2_size=4, c_idx=2)

        c.encode_terminate(1 if last_in_slice else 0)

    def payload(self) -> bytes:
        return self.c.getvalue()
