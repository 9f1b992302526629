"""H.264 high-level syntax: NAL units, SPS, PPS, slice headers.

Replaces the parameter-set machinery ffmpeg/x264 provided for the
reference (codec strings extracted in worker/hwaccel.py:864-981 come from
exactly these bytes). Spec: ITU-T H.264 7.3 (syntax), annex A (profiles).

We emit Constrained Baseline (profile_idc 66, constraint_set0+1) for
CAVLC streams and Main (77) for CABAC (CABAC is prohibited in Baseline,
spec A.2.1), 4:2:0, frame MBs, pic_order_cnt_type 2 (output order ==
decode order — right for all-intra and low-delay). Deblocking is
signalled per slice: chain mode runs the in-loop filter
(codecs/h264/deblock.py, disable_deblocking_filter_idc=0), intra mode
leaves it off (idc=1); either way encoder/decoder reconstructions stay
identical.
"""

from __future__ import annotations

from dataclasses import dataclass

from vlog_tpu_torch.media.bitstream import BitWriter, escape_emulation


# NAL unit types (spec 7.4.1, table 7-1)
NAL_SLICE = 1
NAL_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8

PROFILE_BASELINE = 66
PROFILE_MAIN = 77
PROFILE_HIGH = 100


@dataclass(frozen=True)
class NalUnit:
    nal_unit_type: int
    nal_ref_idc: int
    rbsp: bytes

    def to_bytes(self) -> bytes:
        """Header byte + emulation-protected payload."""
        header = (self.nal_ref_idc << 5) | self.nal_unit_type
        return bytes([header]) + escape_emulation(self.rbsp)


def annexb(nals: list[NalUnit]) -> bytes:
    """Annex-B byte stream (4-byte start codes)."""
    return b"".join(b"\x00\x00\x00\x01" + n.to_bytes() for n in nals)


def _level_for(width: int, height: int, fps: float) -> int:
    """Pick the smallest level_idc covering the frame size + rate.

    MB/s and frame-size limits from spec table A-1 (common subset).
    """
    mbs = ((width + 15) // 16) * ((height + 15) // 16)
    mbps = mbs * fps
    # (level_idc, max_fs_mbs, max_mbps)
    table = [
        (10, 99, 1485), (11, 396, 3000), (12, 396, 6000), (13, 396, 11880),
        (20, 396, 11880), (21, 792, 19800), (22, 1620, 20250),
        (30, 1620, 40500), (31, 3600, 108000), (32, 5120, 216000),
        (40, 8192, 245760), (41, 8192, 245760), (42, 8704, 522240),
        (50, 22080, 589824), (51, 36864, 983040), (52, 36864, 2073600),
    ]
    for level, max_fs, max_mbps in table:
        if mbs <= max_fs and mbps <= max_mbps:
            return level
    return 52


@dataclass(frozen=True)
class SpsConfig:
    width: int
    height: int
    fps_num: int = 30
    fps_den: int = 1
    profile_idc: int = PROFILE_BASELINE
    level_idc: int = 0  # 0 = auto
    max_num_ref_frames: int = 1
    log2_max_frame_num: int = 8
    full_range: bool = False
    bt709: bool = True

    @property
    def mb_width(self) -> int:
        return (self.width + 15) // 16

    @property
    def mb_height(self) -> int:
        return (self.height + 15) // 16

    @property
    def level(self) -> int:
        if self.level_idc:
            return self.level_idc
        return _level_for(self.width, self.height, self.fps_num / self.fps_den)


def make_sps(cfg: SpsConfig, sps_id: int = 0) -> NalUnit:
    """seq_parameter_set_rbsp (spec 7.3.2.1.1) with minimal VUI timing."""
    w = BitWriter()
    w.write_bits(cfg.profile_idc, 8)
    # constraint_set0..5 + reserved_zero_2bits: constrained baseline
    w.write_bits(0b11000000 if cfg.profile_idc == PROFILE_BASELINE else 0, 8)
    w.write_bits(cfg.level, 8)
    w.write_ue(sps_id)
    w.write_ue(cfg.log2_max_frame_num - 4)   # log2_max_frame_num_minus4
    w.write_ue(2)                            # pic_order_cnt_type
    w.write_ue(cfg.max_num_ref_frames)
    w.write_bit(0)                           # gaps_in_frame_num_value_allowed
    w.write_ue(cfg.mb_width - 1)
    w.write_ue(cfg.mb_height - 1)
    w.write_bit(1)                           # frame_mbs_only_flag
    w.write_bit(1)                           # direct_8x8_inference_flag
    crop_r = (cfg.mb_width * 16 - cfg.width) // 2
    crop_b = (cfg.mb_height * 16 - cfg.height) // 2
    if crop_r or crop_b:
        w.write_bit(1)
        w.write_ue(0)
        w.write_ue(crop_r)
        w.write_ue(0)
        w.write_ue(crop_b)
    else:
        w.write_bit(0)
    # VUI: colour description + timing
    w.write_bit(1)                           # vui_parameters_present_flag
    w.write_bit(0)                           # aspect_ratio_info_present
    w.write_bit(0)                           # overscan_info_present
    w.write_bit(1)                           # video_signal_type_present
    w.write_bits(5, 3)                       # video_format: unspecified
    w.write_bit(1 if cfg.full_range else 0)  # video_full_range_flag
    w.write_bit(1)                           # colour_description_present
    prim = 1 if cfg.bt709 else 6             # BT.709 / BT.601-525
    w.write_bits(prim, 8)                    # colour_primaries
    w.write_bits(1 if cfg.bt709 else 6, 8)   # transfer_characteristics
    w.write_bits(1 if cfg.bt709 else 6, 8)   # matrix_coefficients
    w.write_bit(0)                           # chroma_loc_info_present
    w.write_bit(1)                           # timing_info_present
    w.write_bits(cfg.fps_den, 32)            # num_units_in_tick
    w.write_bits(cfg.fps_num * 2, 32)        # time_scale (field rate)
    w.write_bit(1)                           # fixed_frame_rate_flag
    w.write_bit(0)                           # nal_hrd_parameters_present
    w.write_bit(0)                           # vcl_hrd_parameters_present
    w.write_bit(0)                           # pic_struct_present_flag
    w.write_bit(0)                           # bitstream_restriction_flag
    w.rbsp_trailing_bits()
    return NalUnit(NAL_SPS, 3, w.getvalue())


def make_pps(pps_id: int = 0, sps_id: int = 0, init_qp: int = 26,
             cabac: bool = False) -> NalUnit:
    """pic_parameter_set_rbsp (spec 7.3.2.2), deblock-controllable."""
    w = BitWriter()
    w.write_ue(pps_id)
    w.write_ue(sps_id)
    w.write_bit(1 if cabac else 0)   # entropy_coding_mode_flag
    w.write_bit(0)            # bottom_field_pic_order_in_frame_present
    w.write_ue(0)             # num_slice_groups_minus1
    w.write_ue(0)             # num_ref_idx_l0_default_active_minus1
    w.write_ue(0)             # num_ref_idx_l1_default_active_minus1
    w.write_bit(0)            # weighted_pred_flag
    w.write_bits(0, 2)        # weighted_bipred_idc
    w.write_se(init_qp - 26)  # pic_init_qp_minus26
    w.write_se(0)             # pic_init_qs_minus26
    w.write_se(0)             # chroma_qp_index_offset
    w.write_bit(1)            # deblocking_filter_control_present_flag
    w.write_bit(0)            # constrained_intra_pred_flag
    w.write_bit(0)            # redundant_pic_cnt_present_flag
    w.rbsp_trailing_bits()
    return NalUnit(NAL_PPS, 3, w.getvalue())


SLICE_P = 0
SLICE_I = 7   # 7 = I (and signals "all slices in picture are I")


def write_slice_header(
    w: BitWriter,
    *,
    first_mb: int,
    slice_qp: int,
    init_qp: int,
    idr: bool,
    frame_num: int,
    idr_pic_id: int = 0,
    log2_max_frame_num: int = 8,
    slice_type: int = SLICE_I,
    cabac: bool = False,
    deblock: bool = False,
) -> None:
    """slice_header (spec 7.3.3) for our stream shape.

    pic_order_cnt_type=2 and frame_mbs_only keep this short. The PPS
    sets deblocking_filter_control_present_flag, so every slice signals
    the filter explicitly: idc=0 (on, zero offsets — the in-loop filter
    in codecs/h264/deblock.py mirrors the decoder exactly) or idc=1
    (off). P slices use the PPS default single reference (no override,
    no list modification).
    """
    is_p = slice_type in (0, 5)
    w.write_ue(first_mb)
    w.write_ue(slice_type)
    w.write_ue(0)                                  # pic_parameter_set_id
    w.write_bits(frame_num % (1 << log2_max_frame_num), log2_max_frame_num)
    if idr:
        w.write_ue(idr_pic_id)
    if is_p:
        w.write_bit(0)   # num_ref_idx_active_override_flag (1 ref, PPS)
        w.write_bit(0)   # ref_pic_list_modification_flag_l0
    # dec_ref_pic_marking (nal_ref_idc != 0)
    if idr:
        w.write_bit(0)   # no_output_of_prior_pics_flag
        w.write_bit(0)   # long_term_reference_flag
    else:
        w.write_bit(0)   # adaptive_ref_pic_marking_mode_flag
    if cabac and is_p:
        w.write_ue(0)    # cabac_init_idc
    w.write_se(slice_qp - init_qp)                 # slice_qp_delta
    # disable_deblocking_filter_idc: 0 = filter on (zero offsets), 1 = off
    if deblock:
        w.write_ue(0)
        w.write_se(0)                              # slice_alpha_c0_offset_div2
        w.write_se(0)                              # slice_beta_offset_div2
    else:
        w.write_ue(1)


def avcc_config(sps: NalUnit, pps: NalUnit) -> bytes:
    """AVCDecoderConfigurationRecord (ISO 14496-15 5.3.3.1) for avc1/avcC.

    The media layer's MP4 mux embeds this; browsers derive the codecs=
    string (e.g. avc1.42C028) from bytes 1-3.
    """
    sps_b = sps.to_bytes()
    pps_b = pps.to_bytes()
    out = bytearray()
    out.append(1)                 # configurationVersion
    out += sps_b[1:4]             # profile, compat, level from SPS
    out.append(0xFC | 3)          # lengthSizeMinusOne = 3 (4-byte lengths)
    out.append(0xE0 | 1)          # numOfSequenceParameterSets
    out += len(sps_b).to_bytes(2, "big") + sps_b
    out.append(1)                 # numOfPictureParameterSets
    out += len(pps_b).to_bytes(2, "big") + pps_b
    return bytes(out)


def codec_string(sps: NalUnit) -> str:
    """RFC 6381 codecs= value, e.g. ``avc1.42C028``.

    Reference extracted this by probing ffmpeg output
    (worker/hwaccel.py:864-981); here it falls out of the SPS bytes.
    """
    b = sps.to_bytes()
    return f"avc1.{b[1]:02X}{b[2]:02X}{b[3]:02X}"


def length_prefixed(nals: list[NalUnit]) -> bytes:
    """AVCC sample format: 4-byte big-endian length before each NAL."""
    out = bytearray()
    for n in nals:
        raw = n.to_bytes()
        out += len(raw).to_bytes(4, "big") + raw
    return bytes(out)
