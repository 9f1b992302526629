"""H.264 CABAC slice writers (port of the slice-level half of
``vlog_tpu/codecs/h264/cabac_enc.py``).

The slice header is written in Python; the slice data goes through the
native C coder (native/h264_cabac_enc.c, a copy of the JAX package's),
which returns header + CABAC payload as one RBSP. The port has no Python
CABAC engine: a coder that fails raises.
"""

from __future__ import annotations

import ctypes

import numpy as np

from vlog_tpu_torch.codecs.h264 import syntax
from vlog_tpu_torch.media.bitstream import BitWriter


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
