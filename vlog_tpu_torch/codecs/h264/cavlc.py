"""H.264 CAVLC slice writers and the host state the decoder shares with
them (port of ``vlog_tpu/codecs/h264/cavlc.py``: its slice-level half,
the scan order, the nC rule, the inter CBP mapping and the MV predictor).

The slice header is written in Python; the slice data goes through the
native C coder (native/cavlc.c, a copy of the JAX package's), which
continues the header's partial last byte and returns header + slice data
+ trailing bits as one RBSP. The port has no Python CAVLC coder: a coder
that fails raises.

Spec: ITU-T H.264 7.3.5 (macroblock layer), 9.2 (CAVLC).
"""

from __future__ import annotations

import ctypes

import numpy as np

from vlog_tpu_torch.codecs.h264 import syntax
from vlog_tpu_torch.codecs.h264.cavlc_tables import ZIGZAG_4x4
from vlog_tpu_torch.media.bitstream import BitWriter

_ZZ_R = np.array([r for r, _ in ZIGZAG_4x4])
_ZZ_C = np.array([c for _, c in ZIGZAG_4x4])


def _nc(avail_a: bool, na: int, avail_b: bool, nb: int) -> int:
    """Neighbour context (spec 9.2.1): nA left, nB above."""
    if avail_a and avail_b:
        return (na + nb + 1) >> 1
    if avail_a:
        return na
    if avail_b:
        return nb
    return 0


# Table 9-4 column "Inter": codeNum -> coded_block_pattern.
_CBP_INTER_FROM_CODE = [
    0, 16, 1, 2, 4, 8, 32, 3, 5, 10, 12, 15, 47, 7, 11, 13,
    14, 6, 9, 31, 35, 37, 42, 44, 33, 34, 36, 40, 39, 43, 45, 46,
    17, 18, 20, 24, 19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41,
]

# 4x4 luma block coding order as (i8x8, i4x4) -> (by, bx) within the MB.
_BLK44 = [(0, 0), (0, 1), (1, 0), (1, 1)]


def _median3(a: int, b: int, c: int) -> int:
    return sorted((a, b, c))[1]


class MvPredictor:
    """The spec's MV prediction state machine (8.4.1.3 + 8.4.1.1),
    shared verbatim between the P-slice encoder and decoder so the two
    can never drift. Holds reconstructed MVs in QUARTER pels, (x, y)."""

    def __init__(self, mbh: int, mbw: int):
        self.mbh = mbh
        self.mbw = mbw
        self.mvs = np.zeros((mbh, mbw, 2), np.int32)

    def _neighbor(self, my: int, mx: int):
        """(avail, mv) triplets for A (left), B (top), C (top-right with
        D top-left fallback)."""
        a_ok = mx > 0
        b_ok = my > 0
        c_ok = b_ok and mx < self.mbw - 1
        d_ok = b_ok and mx > 0
        a = self.mvs[my, mx - 1] if a_ok else np.zeros(2, np.int32)
        b = self.mvs[my - 1, mx] if b_ok else np.zeros(2, np.int32)
        if c_ok:
            c_av, c = True, self.mvs[my - 1, mx + 1]
        elif d_ok:
            c_av, c = True, self.mvs[my - 1, mx - 1]
        else:
            c_av, c = False, np.zeros(2, np.int32)
        return (a_ok, a), (b_ok, b), (c_av, c)

    def mv_pred(self, my: int, mx: int) -> tuple[int, int]:
        """Median predictor, 8.4.1.3.1 (single ref list, all-inter)."""
        (a_ok, a), (b_ok, b), (c_ok, c) = self._neighbor(my, mx)
        avail = [(a_ok, a), (b_ok, b), (c_ok, c)]
        matches = [mv for ok, mv in avail if ok]
        if len(matches) == 1:
            return int(matches[0][0]), int(matches[0][1])
        return (_median3(int(a[0]), int(b[0]), int(c[0])),
                _median3(int(a[1]), int(b[1]), int(c[1])))

    def skip_mv(self, my: int, mx: int) -> tuple[int, int]:
        """P_Skip inferred MV, 8.4.1.1."""
        (a_ok, a), (b_ok, b), _ = self._neighbor(my, mx)
        if (not a_ok or not b_ok
                or (a[0] == 0 and a[1] == 0)
                or (b[0] == 0 and b[1] == 0)):
            return 0, 0
        return self.mv_pred(my, mx)


def _native_cavlc(kind: str, arrays: list, mbh: int, mbw: int,
                  header: BitWriter) -> bytes:
    from vlog_tpu_torch.native import get_lib

    lib = get_lib()
    arrs = [np.ascontiguousarray(a, np.int32) for a in arrays]
    # worst-case CAVLC expansion of every coefficient
    cap = 64 + mbh * mbw * (384 * 4)
    out = np.empty(cap, np.uint8)
    n_scratch = mbh * 4 * mbw * 4 + 2 * mbh * 2 * mbw * 2
    if kind == "p":
        n_scratch += mbh * mbw * 2
    scratch = np.empty(n_scratch, np.int32)
    header_bytes = bytes(header._bytes)
    hdr = (np.frombuffer(header_bytes, np.uint8) if header_bytes
           else np.empty(0, np.uint8))

    def ptr(a, t=ctypes.c_int32):
        return a.ctypes.data_as(ctypes.POINTER(t))

    fn = (lib.vt_cavlc_encode_slice if kind == "i"
          else lib.vt_cavlc_encode_p_slice)
    n = fn(*(ptr(a) for a in arrs), mbh, mbw,
           ptr(hdr, ctypes.c_uint8), len(header_bytes),
           header._cur, header._nbits, ptr(scratch),
           ptr(out, ctypes.c_uint8), cap)
    if n < 0:
        raise RuntimeError(f"native CAVLC {kind}-slice coder failed ({n})")
    return out[:n].tobytes()


def encode_slice(levels, *, qp: int, init_qp: int, frame_num: int = 0,
                 idr: bool = True, idr_pic_id: int = 0,
                 log2_max_frame_num: int = 8,
                 deblock: bool = False) -> syntax.NalUnit:
    """I-slice NAL (Intra_16x16) from a FrameLevels."""
    w = BitWriter()
    syntax.write_slice_header(
        w, first_mb=0, slice_qp=qp, init_qp=init_qp, idr=idr,
        frame_num=frame_num, idr_pic_id=idr_pic_id,
        log2_max_frame_num=log2_max_frame_num, deblock=deblock)
    rbsp = _native_cavlc(
        "i", [levels.luma_dc, levels.luma_ac, levels.chroma_dc,
              levels.chroma_ac], levels.mb_height, levels.mb_width, w)
    return syntax.NalUnit(syntax.NAL_IDR if idr else syntax.NAL_SLICE, 3, rbsp)


def encode_p_slice(plevels: dict, *, qp: int, init_qp: int, frame_num: int,
                   log2_max_frame_num: int = 8,
                   deblock: bool = False) -> syntax.NalUnit:
    """P-slice NAL (P_Skip / P_L0_16x16, quarter-pel MVDs)."""
    mbh, mbw = plevels["luma"].shape[:2]
    w = BitWriter()
    syntax.write_slice_header(
        w, first_mb=0, slice_qp=qp, init_qp=init_qp, idr=False,
        frame_num=frame_num, log2_max_frame_num=log2_max_frame_num,
        slice_type=syntax.SLICE_P, deblock=deblock)
    rbsp = _native_cavlc("p", [plevels["luma"], plevels["chroma_dc"],
                               plevels["chroma_ac"], plevels["mv"]],
                         mbh, mbw, w)
    return syntax.NalUnit(syntax.NAL_SLICE, 3, rbsp)
