"""H.264 decoder: entropy parse on the host, reconstruction in PyTorch on
an explicit device (port of ``vlog_tpu/codecs/h264/decoder.py``).

NAL/slice parsing and the CAVLC or CABAC entropy decode run on the host
(sequential bit work, pure Python as in the JAX package); pixel
reconstruction (dequantize, inverse transforms, intra prediction, motion
compensation) and the in-loop deblocking filter run on the decoder's
device, default ``"cuda"``. The reference picture stays on the device
between frames; decoded frames leave as uint8 numpy planes.

Scope, as in the JAX package: 4:2:0, frame MBs, one slice per picture, I
slices in the prediction layout our encoder emits (MB row 0: Intra_16x16
DC + chroma DC; rows below: Intra_16x16 Vertical + chroma Vertical), P
slices of P_Skip / P_L0_16x16 with one reference, zero alpha/beta
deblocking offsets. Streams outside this envelope raise
:class:`UnsupportedStream`.

Spec: ITU-T H.264 7.3 (syntax), 9.1 (Exp-Golomb), 9.2 (CAVLC), 9.3
(CABAC), 8.3 (intra prediction), 8.4 (inter prediction), 8.5
(transforms), 8.7 (deblocking).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from vlog_tpu_torch.codecs.h264 import syntax
from vlog_tpu_torch.codecs.h264.cavlc import (
    _BLK44,
    _CBP_INTER_FROM_CODE,
    _ZZ_C,
    _ZZ_R,
    MvPredictor,
    _nc,
)
from vlog_tpu_torch.codecs.h264.cavlc_tables import (
    CHROMA_DC_COEFF_TOKEN_BITS,
    CHROMA_DC_COEFF_TOKEN_LEN,
    CHROMA_DC_TOTAL_ZEROS_BITS,
    CHROMA_DC_TOTAL_ZEROS_LEN,
    COEFF_TOKEN_BITS,
    COEFF_TOKEN_LEN,
    LUMA_BLOCK_ORDER,
    RUN_BEFORE_BITS,
    RUN_BEFORE_LEN,
    TOTAL_ZEROS_BITS,
    TOTAL_ZEROS_LEN,
    coeff_token_table,
)
from vlog_tpu_torch.codecs.h264.deblock import deblock_frame, intra_bs, p_bs
from vlog_tpu_torch.codecs.h264.encoder import (_chroma_dc_pred, _set_dc,
                                                chroma_qp)
from vlog_tpu_torch.codecs.h264.inter import mc_chroma, mc_luma
from vlog_tpu_torch.device import resolve_device
from vlog_tpu_torch.media.bitstream import BitReader, unescape_emulation
from vlog_tpu_torch.ops.transform import (
    dequantize,
    dequantize_chroma_dc,
    dequantize_luma_dc,
    inverse_core_transform,
)


class DecodeError(ValueError):
    """Malformed bitstream."""


class UnsupportedStream(DecodeError):
    """Valid H.264, but outside this decoder's envelope."""


# --------------------------------------------------------------------------
# Inverse VLC tables: {(length, bits): value}, built once at import.
# --------------------------------------------------------------------------

def _invert(bits: np.ndarray, lens: np.ndarray) -> dict[tuple[int, int], int]:
    out: dict[tuple[int, int], int] = {}
    flat_b = np.asarray(bits).reshape(-1)
    flat_l = np.asarray(lens).reshape(-1)
    for idx in range(flat_b.shape[0]):
        ln = int(flat_l[idx])
        if ln > 0:
            out[(ln, int(flat_b[idx]))] = idx
    return out

_COEFF_TOKEN_INV = [_invert(COEFF_TOKEN_BITS[t], COEFF_TOKEN_LEN[t]) for t in range(4)]
_CHROMA_DC_COEFF_TOKEN_INV = _invert(CHROMA_DC_COEFF_TOKEN_BITS, CHROMA_DC_COEFF_TOKEN_LEN)
_TOTAL_ZEROS_INV = [_invert(TOTAL_ZEROS_BITS[i], TOTAL_ZEROS_LEN[i]) for i in range(16)]
_CHROMA_DC_TOTAL_ZEROS_INV = [
    _invert(CHROMA_DC_TOTAL_ZEROS_BITS[i], CHROMA_DC_TOTAL_ZEROS_LEN[i]) for i in range(3)
]
_RUN_BEFORE_INV = [_invert(RUN_BEFORE_BITS[i], RUN_BEFORE_LEN[i]) for i in range(7)]


def _read_vlc(r: BitReader, table: dict[tuple[int, int], int], what: str,
              max_len: int = 16) -> int:
    """Read one prefix-free codeword by extending bit by bit."""
    bits = 0
    for ln in range(1, max_len + 1):
        bits = (bits << 1) | r.read_bit()
        hit = table.get((ln, bits))
        if hit is not None:
            return hit
    raise DecodeError(f"no {what} codeword within {max_len} bits")


# --------------------------------------------------------------------------
# High-level syntax parsing (inverse of syntax.py writers)
# --------------------------------------------------------------------------

def split_annexb(data: bytes) -> list[tuple[int, int, bytes]]:
    """Annex-B stream -> [(nal_type, nal_ref_idc, rbsp)] (unescaped)."""
    nals = []
    n = len(data)
    starts = []
    i = data.find(b"\x00\x00\x01")
    while i != -1:
        starts.append(i + 3)
        i = data.find(b"\x00\x00\x01", i + 3)
    for k, s in enumerate(starts):
        end = n
        if k + 1 < len(starts):
            end = starts[k + 1] - 3
            # Strip all trailing_zero_8bits before the next start code
            # (safe: rbsp_trailing_bits guarantees a nonzero final byte).
            while end > s and data[end - 1] == 0:
                end -= 1
        raw = data[s:end]
        if not raw:
            continue
        header = raw[0]
        nals.append((header & 0x1F, (header >> 5) & 3, unescape_emulation(raw[1:])))
    return nals


def split_avcc(sample: bytes, length_size: int = 4) -> list[tuple[int, int, bytes]]:
    """Length-prefixed (AVCC) sample -> [(nal_type, ref_idc, rbsp)]."""
    nals = []
    pos = 0
    n = len(sample)
    while pos + length_size <= n:
        ln = int.from_bytes(sample[pos:pos + length_size], "big")
        pos += length_size
        if ln == 0 or pos + ln > n:
            raise DecodeError("bad AVCC length field")
        raw = sample[pos:pos + ln]
        pos += ln
        header = raw[0]
        nals.append((header & 0x1F, (header >> 5) & 3, unescape_emulation(raw[1:])))
    return nals


@dataclass(frozen=True)
class Sps:
    profile_idc: int
    level_idc: int
    sps_id: int
    log2_max_frame_num: int
    pic_order_cnt_type: int
    mb_width: int
    mb_height: int
    crop_left: int
    crop_right: int
    crop_top: int
    crop_bottom: int

    @property
    def width(self) -> int:
        return self.mb_width * 16 - 2 * (self.crop_left + self.crop_right)

    @property
    def height(self) -> int:
        return self.mb_height * 16 - 2 * (self.crop_top + self.crop_bottom)


@dataclass(frozen=True)
class Pps:
    pps_id: int
    sps_id: int
    entropy_coding_mode: int
    init_qp: int
    chroma_qp_index_offset: int
    deblocking_filter_control_present: bool


def parse_sps(rbsp: bytes) -> Sps:
    r = BitReader(rbsp)
    profile = r.read_bits(8)
    r.read_bits(8)  # constraint flags + reserved
    level = r.read_bits(8)
    sps_id = r.read_ue()
    if profile in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        chroma_format = r.read_ue()
        if chroma_format == 3:
            r.read_bit()
        r.read_ue()  # bit_depth_luma_minus8
        r.read_ue()  # bit_depth_chroma_minus8
        r.read_bit()  # qpprime_y_zero_transform_bypass
        if r.read_bit():  # seq_scaling_matrix_present
            raise UnsupportedStream("scaling matrices not supported")
        if chroma_format != 1:
            raise UnsupportedStream("only 4:2:0 supported")
    log2_mfn = r.read_ue() + 4
    poc_type = r.read_ue()
    if poc_type == 0:
        r.read_ue()  # log2_max_pic_order_cnt_lsb_minus4
    elif poc_type == 1:
        r.read_bit()
        r.read_se()
        r.read_se()
        for _ in range(r.read_ue()):
            r.read_se()
    r.read_ue()   # max_num_ref_frames
    r.read_bit()  # gaps_in_frame_num_value_allowed
    mbw = r.read_ue() + 1
    mbh_units = r.read_ue() + 1
    frame_mbs_only = r.read_bit()
    if not frame_mbs_only:
        raise UnsupportedStream("interlaced (field) coding not supported")
    mbh = mbh_units
    r.read_bit()  # direct_8x8_inference
    crop = [0, 0, 0, 0]
    if r.read_bit():
        crop = [r.read_ue() for _ in range(4)]  # l, r, t, b
    return Sps(profile, level, sps_id, log2_mfn, poc_type, mbw, mbh,
               crop[0], crop[1], crop[2], crop[3])


def parse_pps(rbsp: bytes) -> Pps:
    r = BitReader(rbsp)
    pps_id = r.read_ue()
    sps_id = r.read_ue()
    entropy = r.read_bit()      # 1 = CABAC (codecs/h264/cabac_dec.py)
    r.read_bit()  # bottom_field_pic_order_in_frame_present
    if r.read_ue() != 0:
        raise UnsupportedStream("slice groups not supported")
    r.read_ue()   # num_ref_idx_l0
    r.read_ue()   # num_ref_idx_l1
    r.read_bit()  # weighted_pred
    r.read_bits(2)
    init_qp = r.read_se() + 26
    r.read_se()   # pic_init_qs
    chroma_qp_off = r.read_se()
    if chroma_qp_off != 0:
        raise UnsupportedStream("chroma_qp_index_offset != 0 not supported")
    deblock_ctrl = bool(r.read_bit())
    r.read_bit()  # constrained_intra_pred_flag (no effect on all-intra)
    if r.read_bit():
        raise UnsupportedStream("redundant_pic_cnt_present_flag not supported")
    return Pps(pps_id, sps_id, entropy, init_qp, chroma_qp_off, deblock_ctrl)


@dataclass
class SliceHeader:
    first_mb: int
    slice_type: int
    pps_id: int
    frame_num: int
    idr: bool
    qp: int
    deblock: bool = False   # disable_deblocking_filter_idc == 0


def parse_slice_header(r: BitReader, sps: Sps, pps: Pps, nal_type: int,
                       nal_ref_idc: int) -> SliceHeader:
    first_mb = r.read_ue()
    slice_type = r.read_ue()
    if slice_type % 5 not in (0, 2):
        raise UnsupportedStream(
            f"only I/P slices supported (slice_type {slice_type})")
    is_p = slice_type % 5 == 0
    pps_id = r.read_ue()
    frame_num = r.read_bits(sps.log2_max_frame_num)
    idr = nal_type == syntax.NAL_IDR
    if idr:
        r.read_ue()  # idr_pic_id
    if sps.pic_order_cnt_type != 2:
        raise UnsupportedStream(
            f"pic_order_cnt_type {sps.pic_order_cnt_type} not supported")
    if is_p:
        if r.read_bit():                 # num_ref_idx_active_override_flag
            if r.read_ue() != 0:         # num_ref_idx_l0_active_minus1
                raise UnsupportedStream("multiple reference frames")
        if r.read_bit():                 # ref_pic_list_modification_flag_l0
            raise UnsupportedStream("ref pic list modification")
    if nal_ref_idc != 0:
        if idr:
            r.read_bit()  # no_output_of_prior_pics
            r.read_bit()  # long_term_reference
        else:
            if r.read_bit():
                raise UnsupportedStream("adaptive ref pic marking not supported")
    if pps.entropy_coding_mode and is_p:
        if r.read_ue() != 0:             # cabac_init_idc
            raise UnsupportedStream("cabac_init_idc != 0 not supported")
    qp = pps.init_qp + r.read_se()
    deblock = False
    if pps.deblocking_filter_control_present:
        idc = r.read_ue()
        if idc == 0:
            deblock = True
            if r.read_se() != 0 or r.read_se() != 0:
                raise UnsupportedStream(
                    "nonzero deblocking alpha/beta offsets not supported")
        elif idc != 1:
            raise UnsupportedStream(f"deblocking idc {idc} not supported")
    return SliceHeader(first_mb, slice_type, pps_id, frame_num, idr, qp,
                       deblock)


# --------------------------------------------------------------------------
# CAVLC residual decode (inverse of cavlc.encode_residual_block)
# --------------------------------------------------------------------------

def decode_residual_block(r: BitReader, nc: int, max_coeff: int) -> np.ndarray:
    """residual_block_cavlc (spec 9.2) -> coefficients in scan order."""
    coeffs = np.zeros(max_coeff, np.int32)
    if nc == -1:
        idx = _read_vlc(r, _CHROMA_DC_COEFF_TOKEN_INV, "chroma coeff_token", 8)
        total_coeff, trailing = idx >> 2, idx & 3
    else:
        tbl = coeff_token_table(nc)
        idx = _read_vlc(r, _COEFF_TOKEN_INV[tbl], "coeff_token", 16)
        total_coeff, trailing = idx >> 2, idx & 3
    if total_coeff == 0:
        return coeffs
    if total_coeff > max_coeff:
        raise DecodeError("TotalCoeff exceeds block size")

    # Values, highest frequency first: trailing ±1s then coded levels.
    values: list[int] = []
    for _ in range(trailing):
        values.append(-1 if r.read_bit() else 1)
    suffix_len = 1 if (total_coeff > 10 and trailing < 3) else 0
    for i in range(total_coeff - trailing):
        prefix = 0
        while r.read_bit() == 0:
            prefix += 1
            if prefix > 32:
                raise DecodeError("level_prefix overflow")
        if prefix <= 15:
            if suffix_len == 0:
                if prefix < 14:
                    code = prefix
                elif prefix == 14:
                    code = 14 + r.read_bits(4)
                else:
                    code = 30 + r.read_bits(12)
            else:
                if prefix < 15:
                    code = (prefix << suffix_len) + r.read_bits(suffix_len)
                else:
                    code = (15 << suffix_len) + r.read_bits(12)
        else:
            # spec 9.2.2.1: prefix >= 16 extends the escape range
            code = (15 << max(suffix_len, 1)) + r.read_bits(prefix - 3)
            code += (1 << (prefix - 3)) - 4096
        if i == 0 and trailing < 3:
            code += 2
        level = (code + 2) >> 1 if code % 2 == 0 else -((code + 1) >> 1)
        values.append(level)
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    # Positions: total_zeros + run_before.
    if total_coeff < max_coeff:
        if nc == -1:
            total_zeros = _read_vlc(
                r, _CHROMA_DC_TOTAL_ZEROS_INV[total_coeff - 1], "chroma total_zeros", 8)
        else:
            total_zeros = _read_vlc(
                r, _TOTAL_ZEROS_INV[total_coeff - 1], "total_zeros", 9)
    else:
        total_zeros = 0

    pos = total_coeff - 1 + total_zeros          # scan index of highest-freq coeff
    zeros_left = total_zeros
    for k, val in enumerate(values):
        coeffs[pos] = val
        if k == total_coeff - 1:
            break
        if zeros_left > 0:
            run = _read_vlc(r, _RUN_BEFORE_INV[min(zeros_left, 7) - 1],
                            "run_before", 11)
        else:
            run = 0
        pos -= run + 1
        zeros_left -= run
        if pos < 0:
            raise DecodeError("run_before underflow")
    return coeffs


def _unzigzag(scan: np.ndarray) -> np.ndarray:
    block = np.zeros((4, 4), np.int32)
    block[_ZZ_R, _ZZ_C] = scan
    return block


# --------------------------------------------------------------------------
# Slice decode -> levels arrays (mirror of cavlc.SliceEncoder)
# --------------------------------------------------------------------------

# Intra16x16 pred modes by position in our layout (see encoder.py docstring)
_ROW0_LUMA_MODE, _ROW0_CHROMA_MODE = 2, 0       # DC
_BODY_LUMA_MODE, _BODY_CHROMA_MODE = 0, 2       # Vertical


def decode_slice_data(r: BitReader, sps: Sps, header: SliceHeader) -> dict:
    """Decode one full-frame I slice into levels arrays.

    Verifies the prediction-mode layout matches the vertical-scan envelope
    the JAX reconstruction implements.
    """
    mbh, mbw = sps.mb_height, sps.mb_width
    if header.first_mb != 0:
        raise UnsupportedStream("multi-slice pictures not supported")
    luma_dc = np.zeros((mbh, mbw, 4, 4), np.int32)
    luma_ac = np.zeros((mbh, mbw, 4, 4, 4, 4), np.int32)
    chroma_dc = np.zeros((2, mbh, mbw, 2, 2), np.int32)
    chroma_ac = np.zeros((2, mbh, mbw, 2, 2, 4, 4), np.int32)
    nz_luma = np.zeros((mbh * 4, mbw * 4), np.int32)
    nz_chroma = np.zeros((2, mbh * 2, mbw * 2), np.int32)
    nc_of = _nc

    for my in range(mbh):
        for mx in range(mbw):
            mb_type = r.read_ue()
            if not 1 <= mb_type <= 24:
                raise UnsupportedStream(f"mb_type {mb_type} (not I_16x16)")
            t = mb_type - 1
            luma_mode = t % 4
            cbp_chroma = (t // 4) % 3
            cbp_luma = 15 if t >= 12 else 0
            chroma_mode = r.read_ue()
            exp_luma = _ROW0_LUMA_MODE if my == 0 else _BODY_LUMA_MODE
            exp_chroma = _ROW0_CHROMA_MODE if my == 0 else _BODY_CHROMA_MODE
            if luma_mode != exp_luma or chroma_mode != exp_chroma:
                raise UnsupportedStream(
                    f"prediction layout mismatch at MB ({my},{mx}): "
                    f"luma {luma_mode}/{exp_luma} chroma {chroma_mode}/{exp_chroma}")
            if r.read_se() != 0:
                raise UnsupportedStream("mb_qp_delta != 0 not supported")

            gy, gx = my * 4, mx * 4
            nc = nc_of(gx > 0, int(nz_luma[gy, gx - 1]),
                       gy > 0, int(nz_luma[gy - 1, gx]))
            luma_dc[my, mx] = _unzigzag(decode_residual_block(r, nc, 16))

            if cbp_luma:
                for by, bx in LUMA_BLOCK_ORDER:
                    y, x = gy + by, gx + bx
                    nc = nc_of(x > 0, int(nz_luma[y, x - 1]),
                               y > 0, int(nz_luma[y - 1, x]))
                    scan15 = decode_residual_block(r, nc, 15)
                    full = np.zeros(16, np.int32)
                    full[1:] = scan15
                    luma_ac[my, mx, by, bx] = _unzigzag(full)
                    nz_luma[y, x] = int(np.count_nonzero(scan15))

            if cbp_chroma > 0:
                for comp in range(2):
                    dc = decode_residual_block(r, -1, 4)
                    chroma_dc[comp, my, mx] = dc.reshape(2, 2)

            if cbp_chroma == 2:
                cy, cx = my * 2, mx * 2
                for comp in range(2):
                    for by in range(2):
                        for bx in range(2):
                            y, x = cy + by, cx + bx
                            nc = nc_of(x > 0, int(nz_chroma[comp, y, x - 1]),
                                       y > 0, int(nz_chroma[comp, y - 1, x]))
                            scan15 = decode_residual_block(r, nc, 15)
                            full = np.zeros(16, np.int32)
                            full[1:] = scan15
                            chroma_ac[comp, my, mx, by, bx] = _unzigzag(full)
                            nz_chroma[comp, y, x] = int(np.count_nonzero(scan15))
    return {
        "luma_dc": luma_dc, "luma_ac": luma_ac,
        "chroma_dc": chroma_dc, "chroma_ac": chroma_ac,
    }


def decode_p_slice_data(r: BitReader, sps: Sps, header: SliceHeader) -> dict:
    """Decode one full-frame P slice (P_Skip / P_L0_16x16 envelope).

    MV prediction state machine is shared with the encoder
    (cavlc.PSliceEncoder.mv_pred/skip_mv), so the two can never drift.
    Returns levels + per-MB MVs in quarter pels.
    """
    mbh, mbw = sps.mb_height, sps.mb_width
    if header.first_mb != 0:
        raise UnsupportedStream("multi-slice pictures not supported")
    luma = np.zeros((mbh, mbw, 4, 4, 4, 4), np.int32)
    chroma_dc = np.zeros((2, mbh, mbw, 2, 2), np.int32)
    chroma_ac = np.zeros((2, mbh, mbw, 2, 2, 4, 4), np.int32)
    nz_luma = np.zeros((mbh * 4, mbw * 4), np.int32)
    nz_chroma = np.zeros((2, mbh * 2, mbw * 2), np.int32)
    mvst = MvPredictor(mbh, mbw)          # shared with the encoder

    n_mbs = mbh * mbw
    mb = 0
    skip_left = r.read_ue()               # leading mb_skip_run
    while mb < n_mbs:
        my, mx = divmod(mb, mbw)
        if skip_left > 0:
            mvst.mvs[my, mx] = mvst.skip_mv(my, mx)
            skip_left -= 1
            mb += 1
            continue
        mb_type = r.read_ue()
        if mb_type != 0:
            raise UnsupportedStream(
                f"P mb_type {mb_type} outside P_L0_16x16 envelope")
        mvd_x = r.read_se()
        mvd_y = r.read_se()
        pmx, pmy = mvst.mv_pred(my, mx)
        mvx, mvy = pmx + mvd_x, pmy + mvd_y
        mvst.mvs[my, mx] = (mvx, mvy)
        cbp = _CBP_INTER_FROM_CODE[r.read_ue()]
        if cbp:
            if r.read_se() != 0:
                raise UnsupportedStream("mb_qp_delta != 0 not supported")
            gy, gx = my * 4, mx * 4
            for i8 in range(4):
                oy, ox = _BLK44[i8]
                for dy, dx in _BLK44:
                    by, bx = 2 * oy + dy, 2 * ox + dx
                    y, x = gy + by, gx + bx
                    if not (cbp >> i8) & 1:
                        nz_luma[y, x] = 0
                        continue
                    nc = _nc(x > 0, int(nz_luma[y, x - 1]),
                             y > 0, int(nz_luma[y - 1, x]))
                    scan = decode_residual_block(r, nc, 16)
                    luma[my, mx, by, bx] = _unzigzag(scan)
                    nz_luma[y, x] = int(np.count_nonzero(scan))
            cbp_chroma = cbp >> 4
            if cbp_chroma > 0:
                for comp in range(2):
                    dc = decode_residual_block(r, -1, 4)
                    chroma_dc[comp, my, mx] = dc.reshape(2, 2)
            cy, cx = my * 2, mx * 2
            for comp in range(2):
                for by in range(2):
                    for bx in range(2):
                        y, x = cy + by, cx + bx
                        if cbp_chroma != 2:
                            nz_chroma[comp, y, x] = 0
                            continue
                        nc = _nc(x > 0, int(nz_chroma[comp, y, x - 1]),
                                 y > 0, int(nz_chroma[comp, y - 1, x]))
                        scan15 = decode_residual_block(r, nc, 15)
                        full = np.zeros(16, np.int32)
                        full[1:] = scan15
                        chroma_ac[comp, my, mx, by, bx] = _unzigzag(full)
                        nz_chroma[comp, y, x] = int(np.count_nonzero(scan15))
        mb += 1
        if mb < n_mbs:
            skip_left = r.read_ue()
    return {
        "luma": luma, "chroma_dc": chroma_dc, "chroma_ac": chroma_ac,
        "mv_q": np.ascontiguousarray(mvst.mvs),   # quarter pels, (x, y)
    }


# --------------------------------------------------------------------------
# Reconstruction (PyTorch) — mirror of encoder.encode_frame's recon path
# --------------------------------------------------------------------------

# MC padding for decode: covers |MV| up to this many pels (our encoder's
# search radius is <= 16; streams beyond it are rejected in _reconstruct).
_P_REF_PAD = 32


def _i32(a, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(a, device=dev).to(torch.int32)


def _luma_resid(dc_levels, ac_levels, qp):
    """(n,mbh,mbw,4,4) DC + (n,mbh,mbw,4,4,4,4) AC -> (n, mbh, 16, W)."""
    full = _set_dc(dequantize(ac_levels, qp=qp),
                    dequantize_luma_dc(dc_levels, qp=qp))
    resid = inverse_core_transform(full)          # (n, mbh, mbw, 4, 4, 4, 4)
    n, mbh, mbw = resid.shape[:3]
    mb = resid.transpose(4, 5).reshape(n, mbh, mbw, 16, 16)
    return mb.transpose(2, 3).reshape(n, mbh, 16, mbw * 16)


def _chroma_resid(dc_levels, ac_levels, qpc):
    """(n,mbh,mbw,2,2) DC + (n,mbh,mbw,2,2,4,4) AC -> (n, mbh, 8, Wc)."""
    full = _set_dc(dequantize(ac_levels, qp=qpc),
                    dequantize_chroma_dc(dc_levels, qp=qpc))
    resid = inverse_core_transform(full)          # (n, mbh, mbw, 2, 2, 4, 4)
    n, mbh, mbw = resid.shape[:3]
    mb = resid.transpose(4, 5).reshape(n, mbh, mbw, 8, 8)
    return mb.transpose(2, 3).reshape(n, mbh, 8, mbw * 8)


def reconstruct_gop(levels: dict, *, qp, device="cuda"):
    """A batch of intra frames' levels (leading ``n`` on every array, the
    JAX ``vmap`` layout) -> (y, u, v) uint8 tensors (n, H, W) / (n, H/2,
    W/2) at the padded size, on ``device``. ``qp``: int or (n,) int32.

    Row 0 is a loop over MB columns (DC prediction from the left
    neighbour's reconstruction), the rows below a loop over MB rows
    (vertical prediction), each step batched over frames and MBs."""
    dev = resolve_device(device)
    luma_dc = _i32(levels["luma_dc"], dev)
    luma_ac = _i32(levels["luma_ac"], dev)
    chroma_dc = _i32(levels["chroma_dc"], dev)
    chroma_ac = _i32(levels["chroma_ac"], dev)
    n, mbh, mbw = luma_dc.shape[:3]
    q = torch.as_tensor(qp, device=dev).to(torch.int32).expand(n)
    qpc = chroma_qp(q).to(torch.int32)

    y_resid = _luma_resid(luma_dc, luma_ac, q)                    # (n,mbh,16,W)
    u_resid = _chroma_resid(chroma_dc[:, 0], chroma_ac[:, 0], qpc)
    v_resid = _chroma_resid(chroma_dc[:, 1], chroma_ac[:, 1], qpc)

    # Row 0: DC prediction with the left neighbour's reconstruction.
    y0, u0, v0 = [], [], []
    for c in range(mbw):
        yr = y_resid[:, 0, :, 16 * c:16 * c + 16]
        ur = u_resid[:, 0, :, 8 * c:8 * c + 8]
        vr = v_resid[:, 0, :, 8 * c:8 * c + 8]
        if c == 0:
            pred_y = pred_u = pred_v = 128
        else:
            dc = (y0[-1][:, :, -1].sum(1, dtype=torch.int32) + 8) >> 4
            pred_y = dc[:, None, None]
            pred_u = _chroma_dc_pred(u0[-1][:, :, -1])
            pred_v = _chroma_dc_pred(v0[-1][:, :, -1])
        y0.append(torch.clamp(pred_y + yr, 0, 255))
        u0.append(torch.clamp(pred_u + ur, 0, 255))
        v0.append(torch.clamp(pred_v + vr, 0, 255))
    ys, us, vs = [torch.cat(y0, 2)], [torch.cat(u0, 2)], [torch.cat(v0, 2)]

    # Rows 1..mbh-1: vertical prediction from the row above.
    for r in range(1, mbh):
        ys.append(torch.clamp(ys[-1][:, -1:] + y_resid[:, r], 0, 255))
        us.append(torch.clamp(us[-1][:, -1:] + u_resid[:, r], 0, 255))
        vs.append(torch.clamp(vs[-1][:, -1:] + v_resid[:, r], 0, 255))
    return tuple(torch.cat(p, 1).to(torch.uint8) for p in (ys, us, vs))


def reconstruct_frame(levels: dict, *, qp: int, device="cuda"):
    """One intra frame's levels (numpy or tensors) -> (y, u, v) uint8
    tensors at the padded size: :func:`reconstruct_gop` on a batch of 1."""
    batch = {k: torch.as_tensor(levels[k])[None]
             for k in ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")}
    return tuple(p[0] for p in reconstruct_gop(batch, qp=qp, device=device))


def reconstruct_p_frame(levels: dict, ref_y, ref_u, ref_v, *, qp: int,
                        device="cuda"):
    """P-frame recon: MC from the previous reconstruction + inter residual
    (mirror of inter.encode_p_frame's decoder loop). ``levels["mv_q"]``
    (mbh, mbw, 2) quarter pels in DSP (y, x) order; reference planes
    (H, W) / (H/2, W/2); returns uint8 tensors on ``device``."""
    dev = resolve_device(device)
    qpc = chroma_qp(int(qp))
    mv = _i32(levels["mv_q"], dev)[None]             # (1, mbh, mbw, 2)
    luma = _i32(levels["luma"], dev)
    chroma_dc = _i32(levels["chroma_dc"], dev)
    chroma_ac = _i32(levels["chroma_ac"], dev)
    mbh, mbw = luma.shape[0], luma.shape[1]
    h, w = mbh * 16, mbw * 16
    ref = [torch.as_tensor(p, device=dev)[None] for p in (ref_y, ref_u, ref_v)]

    pred_y = mc_luma(ref[0], mv, search=_P_REF_PAD)[0]
    pred_u = mc_chroma(ref[1], mv, search=_P_REF_PAD)[0]
    pred_v = mc_chroma(ref[2], mv, search=_P_REF_PAD)[0]

    rec = inverse_core_transform(dequantize(luma, qp=qp))
    y_res = rec.permute(0, 2, 4, 1, 3, 5).reshape(h, w)

    def chroma_res(dc, ac):
        full = _set_dc(dequantize(ac, qp=qpc),
                        dequantize_chroma_dc(dc, qp=qpc))
        res = inverse_core_transform(full)
        return res.permute(0, 2, 4, 1, 3, 5).reshape(h // 2, w // 2)

    y = torch.clamp(pred_y + y_res, 0, 255).to(torch.uint8)
    u = torch.clamp(pred_u + chroma_res(chroma_dc[0], chroma_ac[0]),
                    0, 255).to(torch.uint8)
    v = torch.clamp(pred_v + chroma_res(chroma_dc[1], chroma_ac[1]),
                    0, 255).to(torch.uint8)
    return y, u, v


def deblock_decoded(y, u, v, levels: dict, *, qp: int, is_p: bool):
    """Spec 8.7 in-loop filter of one decoded picture: the encoder's
    wavefront, with bS from the decoded syntax elements (coded luma
    blocks and the (y, x) motion field of a P picture)."""
    dev = y.device
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    if is_p:
        luma = _i32(levels["luma"], dev)
        nz = (luma != 0).any(-1).any(-1)                  # (mbh, mbw, 4, 4)
        nz4 = nz.permute(0, 2, 1, 3).reshape(4 * mbh, 4 * mbw)
        bsv, bsh = p_bs(nz4[None], _i32(levels["mv_q"], dev)[None])
    else:
        bsv, bsh = intra_bs(mbh, mbw, dev)
    out = deblock_frame(y[None], u[None], v[None], qp=qp, bs_v=bsv, bs_h=bsh)
    return tuple(p[0].to(torch.uint8) for p in out)


# --------------------------------------------------------------------------
# Decoder object
# --------------------------------------------------------------------------

@dataclass
class DecodedFrame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray


class H264Decoder:
    """Stateful decoder: feed NALs (AnnexB chunks or AVCC samples), get frames.

    Cropping from the SPS is applied; output planes are (h, w), (h/2, w/2)
    uint8 numpy. Reconstruction runs on ``device`` (default ``"cuda"``,
    which raises without CUDA); the reference picture stays there.
    ``stage_s`` accumulates host-clock seconds of the entropy parse, the
    reconstruction and the deblocking filter (the device is synchronized
    at each boundary).
    """

    def __init__(self, avcc_config: bytes | None = None, *, device="cuda"):
        self.device = resolve_device(device)
        self.sps: Sps | None = None
        self.pps: Pps | None = None
        self._length_size = 4
        self._ref: tuple | None = None      # previous padded recon (y, u, v)
        self.stage_s = {"parse_s": 0.0, "reconstruct_s": 0.0,
                        "deblock_s": 0.0}
        if avcc_config:
            self._parse_avcc_config(avcc_config)

    def _clock(self, stage: str, t0: float) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        self.stage_s[stage] += t1 - t0
        return t1

    def _parse_avcc_config(self, cfg: bytes) -> None:
        """AVCDecoderConfigurationRecord (ISO 14496-15 5.3.3.1)."""
        if len(cfg) < 7 or cfg[0] != 1:
            raise DecodeError("bad avcC")
        self._length_size = (cfg[4] & 3) + 1
        pos = 5
        n_sps = cfg[pos] & 0x1F
        pos += 1
        try:
            for _ in range(n_sps):
                ln = int.from_bytes(cfg[pos:pos + 2], "big")
                pos += 2
                if ln == 0 or pos + ln > len(cfg):
                    raise DecodeError("truncated avcC SPS")
                self._handle_nal(cfg[pos] & 0x1F,
                                 unescape_emulation(cfg[pos + 1:pos + ln]))
                pos += ln
            n_pps = cfg[pos]
            pos += 1
            for _ in range(n_pps):
                ln = int.from_bytes(cfg[pos:pos + 2], "big")
                pos += 2
                if ln == 0 or pos + ln > len(cfg):
                    raise DecodeError("truncated avcC PPS")
                self._handle_nal(cfg[pos] & 0x1F,
                                 unescape_emulation(cfg[pos + 1:pos + ln]))
                pos += ln
        except IndexError as exc:
            raise DecodeError("truncated avcC") from exc
        if self.sps is None or self.pps is None:
            raise DecodeError("avcC carries no SPS/PPS")

    def _handle_nal(self, nal_type: int, rbsp: bytes) -> None:
        if nal_type == syntax.NAL_SPS:
            self.sps = parse_sps(rbsp)
        elif nal_type == syntax.NAL_PPS:
            self.pps = parse_pps(rbsp)

    def _decode_slice_nal(self, nal_type: int, ref_idc: int, rbsp: bytes) -> dict:
        if self.sps is None or self.pps is None:
            raise DecodeError("slice before SPS/PPS")
        r = BitReader(rbsp)
        header = parse_slice_header(r, self.sps, self.pps, nal_type, ref_idc)
        is_p = header.slice_type % 5 == 0
        if self.pps.entropy_coding_mode:
            from vlog_tpu_torch.codecs.h264.cabac_dec import (
                decode_p_slice_data_cabac, decode_slice_data_cabac)

            r.byte_align()               # cabac_alignment_one_bit(s)
            start = (len(rbsp) * 8 - r.bits_remaining) // 8
            data = rbsp[start:]
            levels = (decode_p_slice_data_cabac(data, self.sps, header)
                      if is_p else
                      decode_slice_data_cabac(data, self.sps, header))
        elif is_p:
            levels = decode_p_slice_data(r, self.sps, header)
        else:
            levels = decode_slice_data(r, self.sps, header)
        levels["is_p"] = is_p
        levels["qp"] = header.qp
        levels["deblock"] = header.deblock
        return levels

    def _reconstruct(self, levels: dict) -> tuple:
        """Levels -> padded planes on the device; updates the reference
        picture."""
        qp = levels.pop("qp")
        deblock = levels.pop("deblock", False)
        is_p = levels.pop("is_p", False)
        t0 = time.perf_counter()
        if is_p:
            if self._ref is None:
                raise DecodeError("P slice with no reference picture")
            mv_q = levels.pop("mv_q")                   # (mbh, mbw, 2) (x, y)
            mv = np.stack([mv_q[..., 1], mv_q[..., 0]], axis=-1)
            # pad = _P_REF_PAD+8 in mc_luma keeps gathers in range through
            # |mv| = 32 integer pels (the historical envelope)
            if np.any(np.abs(mv) > 4 * _P_REF_PAD):
                raise UnsupportedStream("MV beyond reference padding")
            levels["mv_q"] = mv                         # DSP (y, x) order
            y, u, v = reconstruct_p_frame(levels, *self._ref, qp=qp,
                                          device=self.device)
        else:
            y, u, v = reconstruct_frame(levels, qp=qp, device=self.device)
        t0 = self._clock("reconstruct_s", t0)
        if deblock:
            y, u, v = deblock_decoded(y, u, v, levels, qp=qp, is_p=is_p)
            self._clock("deblock_s", t0)
        self._ref = (y, u, v)
        return y, u, v

    def decode_sample_levels(self, sample: bytes) -> dict | None:
        """AVCC sample -> levels dict (host arrays), or None if no slice."""
        t0 = time.perf_counter()
        try:
            for nal_type, ref_idc, rbsp in split_avcc(sample,
                                                      self._length_size):
                if nal_type in (syntax.NAL_SLICE, syntax.NAL_IDR):
                    return self._decode_slice_nal(nal_type, ref_idc, rbsp)
                self._handle_nal(nal_type, rbsp)
            return None
        finally:
            self.stage_s["parse_s"] += time.perf_counter() - t0

    def _crop(self, y, u, v) -> DecodedFrame:
        sps = self.sps
        w, h = sps.width, sps.height
        return DecodedFrame(
            y[:h, :w].cpu().numpy(),
            u[:h // 2, :w // 2].cpu().numpy(),
            v[:h // 2, :w // 2].cpu().numpy(),
        )

    def decode_sample(self, sample: bytes) -> DecodedFrame | None:
        levels = self.decode_sample_levels(sample)
        if levels is None:
            return None
        return self._crop(*self._reconstruct(levels))

    def decode_samples(self, samples: list[bytes]) -> list[DecodedFrame]:
        """Batched decode: entropy parse per sample on host, one batched
        reconstruction of the whole batch when the GOP is all-intra with a
        shared QP and no deblocking; otherwise frame by frame."""
        all_levels = []
        for s in samples:
            lv = self.decode_sample_levels(s)
            if lv is not None:
                all_levels.append(lv)
        if not all_levels:
            return []
        qps = {lv["qp"] for lv in all_levels}
        if (len(qps) == 1
                and not any(lv.get("is_p") for lv in all_levels)
                and not any(lv.get("deblock") for lv in all_levels)):
            qp = qps.pop()
            stacked = {
                k: np.stack([lv[k] for lv in all_levels])
                for k in ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")
            }
            t0 = time.perf_counter()
            ys, us, vs = reconstruct_gop(stacked, qp=qp, device=self.device)
            self._clock("reconstruct_s", t0)
            self._ref = (ys[-1], us[-1], vs[-1])
            return [self._crop(ys[i], us[i], vs[i])
                    for i in range(len(all_levels))]
        return [self._crop(*self._reconstruct(lv)) for lv in all_levels]


def decode_annexb(data: bytes, *, device="cuda"
                  ) -> tuple[list[DecodedFrame], Sps | None]:
    """Decode a full Annex-B elementary stream (e.g. a .h264 dump)."""
    dec = H264Decoder(device=device)
    frames: list[DecodedFrame] = []
    for nal_type, ref_idc, rbsp in split_annexb(data):
        if nal_type in (syntax.NAL_SLICE, syntax.NAL_IDR):
            levels = dec._decode_slice_nal(nal_type, ref_idc, rbsp)
            frames.append(dec._crop(*dec._reconstruct(levels)))
        else:
            dec._handle_nal(nal_type, rbsp)
    return frames, dec.sps
