"""H.264 intra frame encoder over a batch of frames (port of
``vlog_tpu/codecs/h264/encoder.py``).

Same restricted mode set as the reference, bit-exact with it:

- MB row 0: Intra_16x16 DC (left neighbour only), chroma DC — a loop
  over MB columns, since each MB predicts from its left neighbour's
  reconstruction.
- MB rows > 0: Intra_16x16 Vertical, chroma Vertical — a loop over MB
  rows, each row one batched tensor op over every MB and every frame.

Frames carry a leading batch dimension ``n`` (the JAX package vmaps);
``qp`` is an int or an ``(n,)`` int32 tensor, one QP per frame.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from vlog_tpu_torch.ops.transform import (
    core_transform,
    dequantize,
    dequantize_chroma_dc,
    dequantize_luma_dc,
    hadamard2x2,
    hadamard4,
    inverse_core_transform,
    quantize,
    quantize_chroma_dc,
    quantize_luma_dc,
)

# Table 8-15: QPc as a function of qPI (chroma_qp_index_offset = 0).
_CHROMA_QP = np.concatenate([
    np.arange(30),
    np.array([29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37,
              38, 38, 38, 39, 39, 39, 39]),
]).astype(np.int32)


def chroma_qp(qp):
    """QPc from luma QP (table 8-15): int -> int, tensor -> tensor."""
    if isinstance(qp, (int, np.integer)):
        return int(_CHROMA_QP[min(max(int(qp), 0), 51)])
    table = torch.as_tensor(_CHROMA_QP, device=qp.device)
    return table[torch.clamp(qp, 0, 51).long()]


@dataclass
class FrameLevels:
    """Quantized levels of one intra frame (numpy, host side).

      luma_dc:   (mbh, mbw, 4, 4)
      luma_ac:   (mbh, mbw, 4, 4, 4, 4)
      chroma_dc: (2, mbh, mbw, 2, 2)
      chroma_ac: (2, mbh, mbw, 2, 2, 4, 4)
    """

    luma_dc: np.ndarray
    luma_ac: np.ndarray
    chroma_dc: np.ndarray
    chroma_ac: np.ndarray
    qp: int

    @property
    def mb_height(self) -> int:
        return self.luma_dc.shape[-4]

    @property
    def mb_width(self) -> int:
        return self.luma_dc.shape[-3]


def _zero_dc(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[..., 0, 0] = 0
    return x


def _set_dc(x: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[..., 0, 0] = dc
    return x


def _luma_encode(y_row, pred, qp):
    """One MB row of luma for every frame. y_row/pred (n, 16, W) int32.

    Returns (dc (n, mbw, 4, 4), ac (n, mbw, 4, 4, 4, 4), recon (n, 16, W)).
    """
    n, _, w = y_row.shape
    mbw = w // 16
    resid = y_row - pred
    mb = resid.reshape(n, 16, mbw, 16).transpose(1, 2)           # (n,mbw,16,16)
    blocks = mb.reshape(n, mbw, 4, 4, 4, 4).transpose(3, 4)
    coefs = core_transform(blocks)
    dc_levels = quantize_luma_dc(hadamard4(coefs[..., 0, 0]), qp=qp)
    ac_levels = _zero_dc(quantize(coefs, qp=qp, intra=True))
    full = _set_dc(dequantize(ac_levels, qp=qp),
                   dequantize_luma_dc(dc_levels, qp=qp))
    resid_rec = inverse_core_transform(full)
    mb_rec = resid_rec.transpose(3, 4).reshape(n, mbw, 16, 16)
    row_rec = mb_rec.transpose(1, 2).reshape(n, 16, w)
    return dc_levels, ac_levels, torch.clamp(pred + row_rec, 0, 255)


def _chroma_encode(c_row, pred, qpc):
    """One MB row of one chroma plane. c_row/pred (n, 8, Wc) int32."""
    n, _, wc = c_row.shape
    mbw = wc // 8
    resid = c_row - pred
    mb = resid.reshape(n, 8, mbw, 8).transpose(1, 2)              # (n,mbw,8,8)
    blocks = mb.reshape(n, mbw, 2, 4, 2, 4).transpose(3, 4)       # (n,mbw,2,2,4,4)
    coefs = core_transform(blocks)
    dc_levels = quantize_chroma_dc(hadamard2x2(coefs[..., 0, 0]), qp=qpc)
    ac_levels = _zero_dc(quantize(coefs, qp=qpc, intra=True))
    full = _set_dc(dequantize(ac_levels, qp=qpc),
                   dequantize_chroma_dc(dc_levels, qp=qpc))
    resid_rec = inverse_core_transform(full)
    mb_rec = resid_rec.transpose(3, 4).reshape(n, mbw, 8, 8)
    row_rec = mb_rec.transpose(1, 2).reshape(n, 8, wc)
    return dc_levels, ac_levels, torch.clamp(pred + row_rec, 0, 255)


def _chroma_dc_pred(left_col: torch.Tensor) -> torch.Tensor:
    """Chroma DC prediction with only the left MB (8.3.4.2): the top
    quadrants use left rows 0..3, the bottom ones rows 4..7. (n, 8)."""
    top = (left_col[:, :4].sum(1, dtype=torch.int32) + 2) >> 2
    bot = (left_col[:, 4:].sum(1, dtype=torch.int32) + 2) >> 2
    col = torch.cat([top[:, None].expand(-1, 4), bot[:, None].expand(-1, 4)], 1)
    return col[:, :, None].expand(-1, 8, 8)


def _encode_row0(y_row, u_row, v_row, qp, qpc):
    """MB row 0, a loop over MB columns (DC prediction from the left)."""
    n, _, w = y_row.shape
    mbw = w // 16
    ydc, yac, udc, uac, vdc, vac = [], [], [], [], [], []
    yrec, urec, vrec = [], [], []
    for c in range(mbw):
        y_mb = y_row[:, :, 16 * c:16 * c + 16]
        u_mb = u_row[:, :, 8 * c:8 * c + 8]
        v_mb = v_row[:, :, 8 * c:8 * c + 8]
        if c == 0:
            pred_y = torch.full_like(y_mb, 128)
            pred_u = torch.full_like(u_mb, 128)
            pred_v = torch.full_like(v_mb, 128)
        else:
            ly = yrec[-1][:, :, -1]
            dc = (ly.sum(1, dtype=torch.int32) + 8) >> 4
            pred_y = dc[:, None, None].expand(-1, 16, 16)
            pred_u = _chroma_dc_pred(urec[-1][:, :, -1])
            pred_v = _chroma_dc_pred(vrec[-1][:, :, -1])
        a, b, r = _luma_encode(y_mb, pred_y, qp)
        ydc.append(a[:, 0]), yac.append(b[:, 0]), yrec.append(r)
        a, b, r = _chroma_encode(u_mb, pred_u, qpc)
        udc.append(a[:, 0]), uac.append(b[:, 0]), urec.append(r)
        a, b, r = _chroma_encode(v_mb, pred_v, qpc)
        vdc.append(a[:, 0]), vac.append(b[:, 0]), vrec.append(r)
    st = lambda xs: torch.stack(xs, 1)                             # noqa: E731
    return (st(ydc), st(yac), st(udc), st(uac), st(vdc), st(vac),
            torch.cat(yrec, 2), torch.cat(urec, 2), torch.cat(vrec, 2))


def encode_frame(y, u, v, *, qp):
    """Encode a batch of 4:2:0 frames to levels + reconstruction.

    y (n, H, W), u/v (n, H/2, W/2) integer tensors, H and W multiples of
    16. ``qp``: int or (n,) int32 tensor. Returns the JAX function's dict
    with a leading ``n`` on every array (its ``vmap`` output layout).
    """
    n, h, w = y.shape
    mbh = h // 16
    if not isinstance(qp, torch.Tensor):
        qp = torch.full((n,), int(qp), dtype=torch.int32, device=y.device)
    qp = qp.to(device=y.device, dtype=torch.int32)
    qpc = chroma_qp(qp).to(torch.int32)
    y32, u32, v32 = y.to(torch.int32), u.to(torch.int32), v.to(torch.int32)

    r0 = _encode_row0(y32[:, :16], u32[:, :8], v32[:, :8], qp, qpc)
    ydc, yac, udc, uac, vdc, vac = ([t] for t in r0[:6])
    yrec, urec, vrec = [r0[6]], [r0[7]], [r0[8]]
    for r in range(1, mbh):
        pred_y = yrec[-1][:, -1:, :].expand(-1, 16, -1)
        pred_u = urec[-1][:, -1:, :].expand(-1, 8, -1)
        pred_v = vrec[-1][:, -1:, :].expand(-1, 8, -1)
        a, b, rec = _luma_encode(y32[:, 16 * r:16 * r + 16], pred_y, qp)
        ydc.append(a), yac.append(b), yrec.append(rec)
        a, b, rec = _chroma_encode(u32[:, 8 * r:8 * r + 8], pred_u, qpc)
        udc.append(a), uac.append(b), urec.append(rec)
        a, b, rec = _chroma_encode(v32[:, 8 * r:8 * r + 8], pred_v, qpc)
        vdc.append(a), vac.append(b), vrec.append(rec)
    st = lambda xs: torch.stack(xs, 1)                             # noqa: E731
    return {
        "luma_dc": st(ydc),                                       # (n,mbh,mbw,4,4)
        "luma_ac": st(yac),                                       # (n,mbh,mbw,4,4,4,4)
        "chroma_dc": torch.stack([st(udc), st(vdc)], 1),          # (n,2,mbh,mbw,2,2)
        "chroma_ac": torch.stack([st(uac), st(vac)], 1),          # (n,2,mbh,mbw,2,2,4,4)
        "recon_y": torch.cat(yrec, 1).to(torch.uint8),
        "recon_u": torch.cat(urec, 1).to(torch.uint8),
        "recon_v": torch.cat(vrec, 1).to(torch.uint8),
    }
