"""H.264 CAVLC slice writers (port of the slice-level half of
``vlog_tpu/codecs/h264/cavlc.py``).

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
from vlog_tpu_torch.media.bitstream import BitWriter


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
