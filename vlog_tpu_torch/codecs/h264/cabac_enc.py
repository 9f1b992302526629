"""H.264 CABAC slice writers (port of the slice-level half of
``vlog_tpu/codecs/h264/cabac_enc.py``) and the context state the CABAC
decoder (``cabac_dec.py``) shares with them.

The slice header is written in Python; the slice data goes through the
native C coder (native/h264_cabac_enc.c, a copy of the JAX package's),
which returns header + CABAC payload as one RBSP. The port has no Python
CABAC engine: a coder that fails raises. Kept in Python, as in the JAX
package: the context initialization, the context bases, the neighbour
grids and the coded_block_flag ctxIdxInc rule, which the decoder reads.
"""

from __future__ import annotations

import ctypes

import numpy as np

from vlog_tpu_torch.codecs.h264 import syntax
from vlog_tpu_torch.codecs.h264.cabac_ctx_tables import INIT_I, INIT_PB
from vlog_tpu_torch.media.bitstream import BitWriter


def init_states_264(slice_qp: int, *, i_slice: bool,
                    cabac_init_idc: int = 0) -> tuple[list, list]:
    """H.264 context init (9.3.1.1) — shared by encoder and decoder so
    the two can never drift."""
    table = INIT_I if i_slice else INIT_PB[cabac_init_idc]
    qp = min(max(slice_qp, 0), 51)
    pstate = [0] * 1024
    mps = [0] * 1024
    for i in range(1024):
        m, n = table[2 * i], table[2 * i + 1]
        pre = min(max(((m * qp) >> 4) + n, 1), 126)
        if pre <= 63:
            pstate[i], mps[i] = 63 - pre, 0
        else:
            pstate[i], mps[i] = pre - 64, 1
    return pstate, mps


# block categories: (ctx offsets into cbf/sig/last/level bases, #coeffs)
#   0 Intra16 luma DC, 1 Intra16 luma AC, 2 luma 4x4, 3 chroma DC,
#   4 chroma AC
_CBF_BASE = 85
_CBF_CAT = (0, 4, 8, 12, 16)
_SIG_BASE = 105
_LAST_BASE = 166
_SIGLAST_CAT = (0, 15, 29, 44, 47)
_LVL_BASE = 227
_LVL_CAT = (0, 10, 20, 30, 39)


class _SliceState:
    """Neighbor grids shared by the ctxIdxInc derivations (9.3.3.1)."""

    def __init__(self, mbh: int, mbw: int):
        self.mbh, self.mbw = mbh, mbw
        self.skip = np.zeros((mbh, mbw), bool)
        self.intra = np.zeros((mbh, mbw), bool)
        self.i16 = np.zeros((mbh, mbw), bool)
        self.cbp_luma = np.zeros((mbh, mbw), np.int32)
        self.cbp_chroma = np.zeros((mbh, mbw), np.int32)
        self.chroma_mode = np.zeros((mbh, mbw), np.int32)
        self.cbf_lumadc = np.zeros((mbh, mbw), np.int32)
        self.cbf_luma44 = np.zeros((mbh * 4, mbw * 4), np.int32)
        self.cbf_chdc = np.zeros((2, mbh, mbw), np.int32)
        self.cbf_ch44 = np.zeros((2, mbh * 2, mbw * 2), np.int32)
        self.mvd = np.zeros((mbh, mbw, 2), np.int32)   # |mvd| (x, y)
        self.prev_qp_delta_nz = False


def cbf_ctx_inc(st: _SliceState, cat: int, my: int, mx: int, comp: int,
                by: int, bx: int, cur_intra: bool) -> int:
    """ctxIdxInc for coded_block_flag: condA + 2*condB from the
    same-category neighbor blocks (9.3.3.1.1.9). Shared by the encoder
    and the decoder (cabac_dec.py) over the same _SliceState grids."""

    def cond(n_my, n_mx, grid_val):
        if not (0 <= n_my < st.mbh and 0 <= n_mx < st.mbw):
            # neighbor MB outside the picture
            return 1 if cur_intra else 0
        return grid_val

    if cat == 0:                        # luma DC: neighbor MB's DC cbf
        a = cond(my, mx - 1,
                 int(st.cbf_lumadc[my, mx - 1]) if mx > 0 else 0)
        b = cond(my - 1, mx,
                 int(st.cbf_lumadc[my - 1, mx]) if my > 0 else 0)
        # available neighbor that is not I16x16: transBlock absent -> 0
        if mx > 0 and not st.i16[my, mx - 1]:
            a = 0
        if my > 0 and not st.i16[my - 1, mx]:
            b = 0
        return a + 2 * b
    if cat in (1, 2):                   # luma 4x4 grid neighbors
        y, x = my * 4 + by, mx * 4 + bx
        a = cond(my, mx - 1 if x % 4 == 0 else mx,
                 int(st.cbf_luma44[y, x - 1]) if x > 0 else 0)
        b = cond(my - 1 if y % 4 == 0 else my, mx,
                 int(st.cbf_luma44[y - 1, x]) if y > 0 else 0)
        return a + 2 * b
    if cat == 3:                        # chroma DC per component
        a = cond(my, mx - 1,
                 int(st.cbf_chdc[comp, my, mx - 1]) if mx > 0 else 0)
        b = cond(my - 1, mx,
                 int(st.cbf_chdc[comp, my - 1, mx]) if my > 0 else 0)
        return a + 2 * b
    y, x = my * 2 + by, mx * 2 + bx     # chroma AC 2x2 grid
    a = cond(my, mx - 1 if x % 2 == 0 else mx,
             int(st.cbf_ch44[comp, y, x - 1]) if x > 0 else 0)
    b = cond(my - 1 if y % 2 == 0 else my, mx,
             int(st.cbf_ch44[comp, y - 1, x]) if y > 0 else 0)
    return a + 2 * b


def _native_cabac(kind: str, arrays: list, mbh: int, mbw: int, qp: int,
                  header: bytes) -> bytes:
    from vlog_tpu_torch.native import get_lib

    lib = get_lib()
    arrs = [np.ascontiguousarray(a, np.int32) for a in arrays]
    scratch = np.zeros((mbh * mbw * 37,), np.int32)
    cap = 64 + len(header) + mbh * mbw * (384 * 4)
    out = np.empty(cap, np.uint8)
    hdr = (np.frombuffer(header, np.uint8) if header
           else np.empty(0, np.uint8))

    def ptr(a, t=ctypes.c_int32):
        return a.ctypes.data_as(ctypes.POINTER(t))

    fn = (lib.vt_h264_cabac_i_slice if kind == "i"
          else lib.vt_h264_cabac_p_slice)
    n = fn(*(ptr(a) for a in arrs), mbh, mbw, qp,
           ptr(hdr, ctypes.c_uint8), len(header), ptr(scratch),
           ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise RuntimeError(f"native CABAC {kind}-slice coder failed ({n})")
    return out[:n].tobytes()


def encode_p_slice_cabac(plevels: dict, *, qp: int, init_qp: int,
                         frame_num: int, log2_max_frame_num: int = 8,
                         deblock: bool = False) -> syntax.NalUnit:
    """P-slice NAL (P_Skip / P_L0_16x16, quarter-pel MVDs)."""
    luma = plevels["luma"]
    mbh, mbw = luma.shape[:2]
    w = BitWriter()
    syntax.write_slice_header(
        w, first_mb=0, slice_qp=qp, init_qp=init_qp, idr=False,
        frame_num=frame_num, log2_max_frame_num=log2_max_frame_num,
        slice_type=syntax.SLICE_P, cabac=True, deblock=deblock)
    w.byte_align(1)                     # cabac_alignment_one_bit(s)
    rbsp = _native_cabac("p", [luma, plevels["chroma_dc"],
                               plevels["chroma_ac"], plevels["mv"]],
                         mbh, mbw, qp, w.getvalue())
    return syntax.NalUnit(syntax.NAL_SLICE, 3, rbsp)


def encode_slice_cabac(levels, *, qp: int, init_qp: int,
                       frame_num: int = 0, idr: bool = True,
                       idr_pic_id: int = 0, log2_max_frame_num: int = 8,
                       deblock: bool = False) -> syntax.NalUnit:
    """I-slice NAL (Intra_16x16) from a FrameLevels."""
    mbh, mbw = levels.mb_height, levels.mb_width
    w = BitWriter()
    syntax.write_slice_header(
        w, first_mb=0, slice_qp=qp, init_qp=init_qp, idr=idr,
        frame_num=frame_num, idr_pic_id=idr_pic_id,
        log2_max_frame_num=log2_max_frame_num, cabac=True, deblock=deblock)
    w.byte_align(1)
    rbsp = _native_cabac(
        "i", [levels.luma_dc, levels.luma_ac, levels.chroma_dc,
              levels.chroma_ac], mbh, mbw, qp, w.getvalue())
    return syntax.NalUnit(syntax.NAL_IDR if idr else syntax.NAL_SLICE, 3, rbsp)
