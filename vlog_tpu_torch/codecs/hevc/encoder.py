"""HEVC all-intra frame encoder — numpy reference implementation (copy of
``vlog_tpu/codecs/hevc/encoder.py``; host only, a second reference for
the device intra DSP in core.py).

Pipeline per 32x32 CTB: exact-vertical (mode 26) prediction, forward
transform, quantization, spec-exact dequant + inverse transform, and
reconstruction — so the recon here equals what any conforming decoder
produces (loop filters are disabled; tests/test_hevc.py decodes
our streams with libavcodec and asserts byte equality).

Dependency shape (the point of mode 26 — see slice.py): a CTB row
depends only on the reconstructed bottom line of the row above, except
CTB row 0 where each CTB's prediction is a flat fill of its *left*
neighbour's top-right reconstructed pixel (H.265 8.4.4.2.2 reference
substitution with no row above).  core.py vectorizes rows >0 across
the width and scans row 0, mirroring codecs/h264/encoder.py.

Reference parity: hevc_nvenc / hevc_vaapi encode in the reference's
re-encode worker (worker/hwaccel.py:509, reencode_worker.py); this is
the TPU-platform equivalent those jobs select via codec="h265".
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from vlog_tpu_torch.codecs.hevc import syntax
from vlog_tpu_torch.codecs.hevc.slice import SliceWriter
from vlog_tpu_torch.codecs.hevc.transform import (
    chroma_qp,
    dequantize,
    forward_transform,
    inverse_transform,
    quantize,
)

CTB = 32


def _pad(plane: np.ndarray, block: int) -> np.ndarray:
    h, w = plane.shape
    ph = (h + block - 1) // block * block
    pw = (w + block - 1) // block * block
    if (ph, pw) == (h, w):
        return plane
    return np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")


def _code_block(src: np.ndarray, pred: np.ndarray, qp: int
                ) -> tuple[np.ndarray | None, np.ndarray]:
    """One TB: returns (levels or None, recon)."""
    res = src.astype(np.int32) - pred.astype(np.int32)
    levels = quantize(forward_transform(res), qp)
    if not np.any(levels):
        return None, pred.astype(np.uint8)
    rec = inverse_transform(dequantize(levels, qp))
    return levels, np.clip(pred.astype(np.int32) + rec, 0, 255).astype(
        np.uint8)


@dataclass
class FrameResult:
    nal: syntax.NalUnit
    recon_y: np.ndarray
    recon_u: np.ndarray
    recon_v: np.ndarray


def encode_frame(y: np.ndarray, u: np.ndarray, v: np.ndarray, qp: int
                 ) -> FrameResult:
    """Encode one IDR frame; planes are uint8, true (display) size.

    Returns the slice NAL plus the (padded-size) reconstruction the
    decoder will produce.
    """
    yp = _pad(np.asarray(y, dtype=np.uint8), CTB)
    up = _pad(np.asarray(u, dtype=np.uint8), CTB // 2)
    vp = _pad(np.asarray(v, dtype=np.uint8), CTB // 2)
    h, w = yp.shape
    rows, cols = h // CTB, w // CTB
    qpc = chroma_qp(qp)

    ry = np.zeros_like(yp)
    ru = np.zeros_like(up)
    rv = np.zeros_like(vp)
    sw = SliceWriter(qp)

    for r in range(rows):
        for c in range(cols):
            y0, x0 = r * CTB, c * CTB
            cy0, cx0 = y0 // 2, x0 // 2
            if r == 0:
                # substituted refs: flat fill of the left neighbour's
                # top-right recon pixel (128 at the frame corner)
                pl = int(ry[0, x0 - 1]) if c else 128
                pu_ = int(ru[0, cx0 - 1]) if c else 128
                pv_ = int(rv[0, cx0 - 1]) if c else 128
                pred_y = np.full((CTB, CTB), pl, np.int32)
                pred_u = np.full((16, 16), pu_, np.int32)
                pred_v = np.full((16, 16), pv_, np.int32)
            else:
                pred_y = np.broadcast_to(ry[y0 - 1, x0:x0 + CTB],
                                         (CTB, CTB)).astype(np.int32)
                pred_u = np.broadcast_to(ru[cy0 - 1, cx0:cx0 + 16],
                                         (16, 16)).astype(np.int32)
                pred_v = np.broadcast_to(rv[cy0 - 1, cx0:cx0 + 16],
                                         (16, 16)).astype(np.int32)

            ll, rec = _code_block(yp[y0:y0 + CTB, x0:x0 + CTB], pred_y, qp)
            ry[y0:y0 + CTB, x0:x0 + CTB] = rec
            lu, rec = _code_block(up[cy0:cy0 + 16, cx0:cx0 + 16], pred_u,
                                  qpc)
            ru[cy0:cy0 + 16, cx0:cx0 + 16] = rec
            lvv, rec = _code_block(vp[cy0:cy0 + 16, cx0:cx0 + 16], pred_v,
                                   qpc)
            rv[cy0:cy0 + 16, cx0:cx0 + 16] = rec

            sw.write_ctu(c, ll, lu, lvv,
                         last_in_slice=(r == rows - 1 and c == cols - 1))

    return FrameResult(syntax.idr_nal(qp, sw.payload()), ry, ru, rv)


def encode_stream(frames, width: int, height: int, qp: int
                  ) -> tuple[bytes, list]:
    """All-IDR annex-B stream for an iterable of (y, u, v) frames."""
    nals = [syntax.write_vps(syntax.level_idc_for(width, height)),
            syntax.write_sps(width, height), syntax.write_pps()]
    recons = []
    for (fy, fu, fv) in frames:
        fr = encode_frame(fy, fu, fv, qp)
        nals.append(fr.nal)
        recons.append((fr.recon_y, fr.recon_u, fr.recon_v))
    return syntax.annexb(nals), recons
