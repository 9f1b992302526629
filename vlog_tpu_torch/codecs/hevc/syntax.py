"""HEVC high-level syntax: NAL units, VPS/SPS/PPS, slice headers.

Stream shape (mirrors the constraints codecs/h264/syntax.py documents
for the H.264 path, adapted to H.265):

- Main profile, 8-bit 4:2:0, all-intra IDR frames.
- CTB = min CU = 32x32 (no coding-quadtree split bits), one 32x32 luma
  TU per CTB (no transform-tree split), 16x16 chroma TUs.
- Picture dimensions padded up to multiples of 32; the true size is
  restored by the SPS conformance window (same crop mechanism H.264's
  frame_cropping serves).
- SAO off, no tiles/WPP.  Deblocking is CONFIGURABLE (write_pps's
  ``deblock`` arg, config.HEVC_DEBLOCK, default on): when signalled on,
  the DSP runs spec 8.7.2 in-loop (codecs/hevc/deblock.py) so recon is
  pred+residual+filter; when off, recon is pred+residual exactly.  The
  PPS flag and the DSP flag must always agree — either way the
  encoder's device reconstruction matches any spec decoder
  bit-for-bit, which tests/test_hevc.py asserts against libavcodec.
- One slice per picture, entropy: CABAC (codecs/hevc/cabac.py).

Reference parity: the reference's HEVC rungs come from hevc_nvenc /
hevc_vaapi ffmpeg encoders (worker/hwaccel.py:509-552); this module is
the header layer of the TPU-native equivalent.
"""

from __future__ import annotations

from dataclasses import dataclass

from vlog_tpu_torch.media.bitstream import BitWriter, escape_emulation

# nal_unit_type (H.265 table 7-1)
NAL_IDR_W_RADL = 19
NAL_VPS = 32
NAL_SPS = 33
NAL_PPS = 34

CTB = 32          # CtbSizeY == MinCbSizeY: no split_cu_flag in the stream

# (MaxLumaPs, level_idc) — H.265 table A.8, general_level_idc = 30*level
_LEVELS = [
    (36864, 30),        # 1
    (122880, 60),       # 2
    (245760, 63),       # 2.1
    (552960, 90),       # 3
    (983040, 93),       # 3.1
    (2228224, 120),     # 4
    (2228224, 123),     # 4.1
    (8912896, 150),     # 5
    (8912896, 153),     # 5.1
    (35651584, 180),    # 6
]


def coded_dims(width: int, height: int) -> tuple[int, int]:
    """Coded (CTB-padded) picture size for true display dimensions."""
    return ((width + CTB - 1) // CTB * CTB,
            (height + CTB - 1) // CTB * CTB)


def level_idc_for(width: int, height: int) -> int:
    """Level for the *coded* picture (pads internally, so VPS and SPS
    agree even when display dims sit just under a level threshold)."""
    cw, ch = coded_dims(width, height)
    luma_ps = cw * ch
    for max_ps, idc in _LEVELS:
        if luma_ps <= max_ps:
            return idc
    return 186  # 6.2


@dataclass
class NalUnit:
    nal_type: int
    rbsp: bytes

    def to_bytes(self) -> bytes:
        """Two-byte H.265 NAL header + emulation-protected payload."""
        b0 = (self.nal_type & 0x3F) << 1        # forbidden_zero + type
        b1 = 1                                  # layer_id 0, tid_plus1 1
        return bytes([b0, b1]) + escape_emulation(self.rbsp)


def annexb(nals: list[NalUnit]) -> bytes:
    out = bytearray()
    for n in nals:
        out += b"\x00\x00\x00\x01" + n.to_bytes()
    return bytes(out)


def _profile_tier_level(w: BitWriter, level_idc: int) -> None:
    """profile_tier_level, maxNumSubLayersMinus1 = 0 (7.3.3)."""
    w.write_bits(0, 2)       # general_profile_space
    w.write_bit(0)           # general_tier_flag
    w.write_bits(1, 5)       # general_profile_idc = Main
    for i in range(32):      # compatibility: Main (1) + Main 10 (2)
        w.write_bit(1 if i in (1, 2) else 0)
    w.write_bit(1)           # general_progressive_source_flag
    w.write_bit(0)           # general_interlaced_source_flag
    w.write_bit(1)           # general_non_packed_constraint_flag
    w.write_bit(1)           # general_frame_only_constraint_flag
    w.write_bits(0, 32)      # general_reserved_zero_44bits
    w.write_bits(0, 12)
    w.write_bits(level_idc, 8)


def write_vps(level_idc: int) -> NalUnit:
    w = BitWriter()
    w.write_bits(0, 4)       # vps_video_parameter_set_id
    w.write_bits(3, 2)       # vps_base_layer_{internal,available}_flag
    w.write_bits(0, 6)       # vps_max_layers_minus1
    w.write_bits(0, 3)       # vps_max_sub_layers_minus1
    w.write_bit(1)           # vps_temporal_id_nesting_flag
    w.write_bits(0xFFFF, 16)  # vps_reserved_0xffff_16bits
    _profile_tier_level(w, level_idc)
    w.write_bit(1)           # vps_sub_layer_ordering_info_present_flag
    w.write_ue(0)            # vps_max_dec_pic_buffering_minus1
    w.write_ue(0)            # vps_max_num_reorder_pics
    w.write_ue(0)            # vps_max_latency_increase_plus1
    w.write_bits(0, 6)       # vps_max_layer_id
    w.write_ue(0)            # vps_num_layer_sets_minus1
    w.write_bit(0)           # vps_timing_info_present_flag
    w.write_bit(0)           # vps_extension_flag
    w.rbsp_trailing_bits()
    return NalUnit(NAL_VPS, w.getvalue())


def write_sps(width: int, height: int) -> NalUnit:
    """``width``/``height`` are the true (display) dimensions; the coded
    size is padded to CTB multiples with a conformance-window crop."""
    cw, ch = coded_dims(width, height)
    w = BitWriter()
    w.write_bits(0, 4)       # sps_video_parameter_set_id
    w.write_bits(0, 3)       # sps_max_sub_layers_minus1
    w.write_bit(1)           # sps_temporal_id_nesting_flag
    _profile_tier_level(w, level_idc_for(cw, ch))
    w.write_ue(0)            # sps_seq_parameter_set_id
    w.write_ue(1)            # chroma_format_idc = 4:2:0
    w.write_ue(cw)           # pic_width_in_luma_samples
    w.write_ue(ch)           # pic_height_in_luma_samples
    if cw != width or ch != height:
        w.write_bit(1)       # conformance_window_flag
        w.write_ue(0)                          # left offset
        w.write_ue((cw - width) // 2)          # right (chroma units)
        w.write_ue(0)                          # top
        w.write_ue((ch - height) // 2)         # bottom
    else:
        w.write_bit(0)
    w.write_ue(0)            # bit_depth_luma_minus8
    w.write_ue(0)            # bit_depth_chroma_minus8
    w.write_ue(4)            # log2_max_pic_order_cnt_lsb_minus4
    w.write_bit(1)           # sps_sub_layer_ordering_info_present_flag
    w.write_ue(0)            # sps_max_dec_pic_buffering_minus1
    w.write_ue(0)            # sps_max_num_reorder_pics
    w.write_ue(0)            # sps_max_latency_increase_plus1
    w.write_ue(2)            # log2_min_luma_coding_block_size_minus3 -> 32
    w.write_ue(0)            # log2_diff_max_min_luma_coding_block_size
    w.write_ue(0)            # log2_min_luma_transform_block_size_minus2
    w.write_ue(3)            # log2_diff_max_min -> max TB 32
    w.write_ue(0)            # max_transform_hierarchy_depth_inter
    w.write_ue(0)            # max_transform_hierarchy_depth_intra
    w.write_bit(0)           # scaling_list_enabled_flag
    w.write_bit(0)           # amp_enabled_flag
    w.write_bit(0)           # sample_adaptive_offset_enabled_flag
    w.write_bit(0)           # pcm_enabled_flag
    w.write_ue(0)            # num_short_term_ref_pic_sets
    w.write_bit(0)           # long_term_ref_pics_present_flag
    w.write_bit(0)           # sps_temporal_mvp_enabled_flag
    w.write_bit(0)           # strong_intra_smoothing_enabled_flag
    w.write_bit(0)           # vui_parameters_present_flag
    w.write_bit(0)           # sps_extension_present_flag
    w.rbsp_trailing_bits()
    return NalUnit(NAL_SPS, w.getvalue())


def write_pps(deblock: bool = False) -> NalUnit:
    w = BitWriter()
    w.write_ue(0)            # pps_pic_parameter_set_id
    w.write_ue(0)            # pps_seq_parameter_set_id
    w.write_bit(0)           # dependent_slice_segments_enabled_flag
    w.write_bit(0)           # output_flag_present_flag
    w.write_bits(0, 3)       # num_extra_slice_header_bits
    w.write_bit(0)           # sign_data_hiding_enabled_flag
    w.write_bit(0)           # cabac_init_present_flag
    w.write_ue(0)            # num_ref_idx_l0_default_active_minus1
    w.write_ue(0)            # num_ref_idx_l1_default_active_minus1
    w.write_se(0)            # init_qp_minus26 (per-frame QP via slice)
    w.write_bit(0)           # constrained_intra_pred_flag
    w.write_bit(0)           # transform_skip_enabled_flag
    w.write_bit(0)           # cu_qp_delta_enabled_flag
    w.write_se(0)            # pps_cb_qp_offset
    w.write_se(0)            # pps_cr_qp_offset
    w.write_bit(0)           # pps_slice_chroma_qp_offsets_present_flag
    w.write_bit(0)           # weighted_pred_flag
    w.write_bit(0)           # weighted_bipred_flag
    w.write_bit(0)           # transquant_bypass_enabled_flag
    w.write_bit(0)           # tiles_enabled_flag
    w.write_bit(0)           # entropy_coding_sync_enabled_flag
    # across-slices off keeps slice headers free of the across-slices
    # flag when deblocking is on (7.3.6.1 gates it on this && !disabled)
    # — pictures are single-slice, so the flag is moot either way
    w.write_bit(0)           # pps_loop_filter_across_slices_enabled_flag
    if deblock:
        # control_present 0 -> 8.7.2 runs with zero beta/tc offsets and
        # no override; nothing more appears here or in slice headers
        w.write_bit(0)       # deblocking_filter_control_present_flag
    else:
        w.write_bit(1)       # deblocking_filter_control_present_flag
        w.write_bit(0)       # deblocking_filter_override_enabled_flag
        w.write_bit(1)       # pps_deblocking_filter_disabled_flag
    w.write_bit(0)           # pps_scaling_list_data_present_flag
    w.write_bit(0)           # lists_modification_present_flag
    w.write_ue(0)            # log2_parallel_merge_level_minus2
    w.write_bit(0)           # slice_segment_header_extension_present_flag
    w.write_bit(0)           # pps_extension_present_flag
    w.rbsp_trailing_bits()
    return NalUnit(NAL_PPS, w.getvalue())


def slice_header_bits(slice_qp: int) -> BitWriter:
    """I-slice IDR header; caller appends CABAC payload after the
    byte-alignment these bits end on (7.3.6.1)."""
    w = BitWriter()
    w.write_bit(1)           # first_slice_segment_in_pic_flag
    w.write_bit(0)           # no_output_of_prior_pics_flag (IDR)
    w.write_ue(0)            # slice_pic_parameter_set_id
    w.write_ue(2)            # slice_type = I
    # SAO off in SPS, IDR -> no POC/RPS fields, temporal MVP off
    w.write_se(slice_qp - 26)  # slice_qp_delta
    # deblocking: PPS disables it and override is off -> nothing here
    # loop_filter_across_slices: only when (sao||deblock) signalled -> no
    # tiles/WPP off -> no entry points
    w.write_bit(1)           # alignment_bit_equal_to_one (7.3.2.10)
    w.byte_align(0)
    return w


def idr_nal(slice_qp: int, cabac_payload: bytes) -> NalUnit:
    hdr = slice_header_bits(slice_qp)
    return NalUnit(NAL_IDR_W_RADL, hdr.getvalue() + cabac_payload)
