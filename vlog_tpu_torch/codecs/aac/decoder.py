"""First-party AAC-LC decoder (ISO/IEC 14496-3 4.4-4.6) (copy of
``vlog_tpu/codecs/aac/decoder.py``).

The ingest half of the audio pipeline: MP4/ADTS uploads carry AAC that
must become PCM for the ladder re-encode and for transcription
(reference: ffmpeg decodes inside the transcode command,
worker/hwaccel.py:700-706; transcription.py:259-299 extracts WAV).

Host-side numpy by design: ingest decode is I/O-adjacent, not the hot
loop (the encoder's MDCT/quantization is the TPU side). Supports the
LC toolset actually seen in uploads: long/short/start/stop windows,
sine+KBD shapes, M/S, intensity stereo, PNS, TNS, pulse data. Not
supported (raise): LTP, gain control, CCE, PCE program config.

Validated against the system libavcodec decoder in tests/test_aac.py
(bit-exact spectra are not meaningful across float IMDCTs; tests assert
high SNR agreement instead).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vlog_tpu_torch.codecs.aac import huffman as H
from vlog_tpu_torch.codecs.aac import tables as T
from vlog_tpu_torch.codecs.aac.adts import AacConfig
from vlog_tpu_torch.codecs.aac.mdct import (
    EIGHT_SHORT_SEQUENCE,
    LONG_START_SEQUENCE,
    LONG_STOP_SEQUENCE,
    ONLY_LONG_SEQUENCE,
    inverse_mdct,
    window_halves,
)
from vlog_tpu_torch.media.bitstream import BitReader

SF_OFFSET = 100          # spec 4.6.2.3.3: gain = 2^(0.25*(sf - 100))


class AacDecodeError(ValueError):
    pass


@dataclass
class IcsInfo:
    window_sequence: int
    window_shape: int
    max_sfb: int
    num_windows: int
    num_window_groups: int
    group_len: list[int]          # windows per group
    swb_offset: list[int]
    num_swb: int


@dataclass
class ChannelData:
    """Per-channel decode intermediates for one frame."""

    ics: IcsInfo
    global_gain: int = 0
    band_books: list[int] = field(default_factory=list)     # per (group, sfb)
    scalefactors: list[int] = field(default_factory=list)   # sf / is_pos / noise
    coeffs: np.ndarray | None = None                        # (1024,) dequantized
    quant: np.ndarray | None = None                         # (1024,) raw levels
    tns: dict | None = None


def _parse_ics_info(r: BitReader, sr_index: int) -> IcsInfo:
    if r.read_bit():
        raise AacDecodeError("ics_reserved_bit set")
    seq = r.read_bits(2)
    shape = r.read_bit()
    if seq == EIGHT_SHORT_SEQUENCE:
        max_sfb = r.read_bits(4)
        grouping = r.read_bits(7)
        group_len = [1]
        for b in range(6, -1, -1):
            if (grouping >> b) & 1:
                group_len[-1] += 1
            else:
                group_len.append(1)
        swb = T.SWB_OFFSET_128[sr_index]
        num_swb = T.NUM_SWB_128[sr_index]
        return IcsInfo(seq, shape, max_sfb, 8, len(group_len), group_len,
                       swb, num_swb)
    max_sfb = r.read_bits(6)
    if r.read_bit():
        raise AacDecodeError("predictor/LTP not supported in LC")
    swb = T.SWB_OFFSET_1024[sr_index]
    num_swb = T.NUM_SWB_1024[sr_index]
    return IcsInfo(seq, shape, max_sfb, 1, 1, [1], swb, num_swb)


def _parse_section_data(r: BitReader, ics: IcsInfo) -> list[int]:
    """Per-(group, sfb) codebook list."""
    bits = 3 if ics.window_sequence == EIGHT_SHORT_SEQUENCE else 5
    esc = (1 << bits) - 1
    books: list[int] = []
    for g in range(ics.num_window_groups):
        k = 0
        while k < ics.max_sfb:
            cb = r.read_bits(4)
            length = 0
            while True:
                incr = r.read_bits(bits)
                length += incr
                if incr != esc:
                    break
            if k + length > ics.max_sfb:
                raise AacDecodeError("section overruns max_sfb")
            books.extend([cb] * length)
            k += length
    return books


def _parse_scale_factors(r: BitReader, ics: IcsInfo, books: list[int],
                         global_gain: int) -> list[int]:
    sf = global_gain
    is_pos = 0
    noise_energy = global_gain - 90
    noise_first = True
    out: list[int] = []
    for g in range(ics.num_window_groups):
        for b in range(ics.max_sfb):
            cb = books[g * ics.max_sfb + b]
            if cb == H.ZERO_HCB:
                out.append(0)
            elif cb in (H.INTENSITY_HCB, H.INTENSITY_HCB2):
                is_pos += H.read_scalefactor(r)
                out.append(is_pos)
            elif cb == H.NOISE_HCB:
                if noise_first:
                    noise_energy += r.read_bits(9) - 256
                    noise_first = False
                else:
                    noise_energy += H.read_scalefactor(r)
                out.append(noise_energy)
            else:
                sf += H.read_scalefactor(r)
                if not 0 <= sf < 256:
                    raise AacDecodeError(f"scalefactor {sf} out of range")
                out.append(sf)
    return out


def _parse_pulse(r: BitReader) -> dict:
    n = r.read_bits(2) + 1
    start_sfb = r.read_bits(6)
    offsets = []
    amps = []
    for _ in range(n):
        offsets.append(r.read_bits(5))
        amps.append(r.read_bits(4))
    return {"start_sfb": start_sfb, "offsets": offsets, "amps": amps}


def _parse_tns(r: BitReader, ics: IcsInfo) -> dict:
    short = ics.window_sequence == EIGHT_SHORT_SEQUENCE
    n_filt_bits, len_bits, order_bits = (1, 4, 3) if short else (2, 6, 5)
    windows = []
    for w in range(ics.num_windows):
        n_filt = r.read_bits(n_filt_bits)
        filters = []
        coef_res = r.read_bit() if n_filt else 0
        for _ in range(n_filt):
            length = r.read_bits(len_bits)
            order = r.read_bits(order_bits)
            f = {"length": length, "order": order}
            if order:
                f["direction"] = r.read_bit()
                compress = r.read_bit()
                bits = coef_res + 3 - compress
                f["coef_res"] = coef_res
                f["compress"] = compress
                f["coefs"] = [r.read_bits(bits) for _ in range(order)]
            filters.append(f)
        windows.append(filters)
    return {"windows": windows}


def _tns_lpc(f: dict) -> np.ndarray:
    """Quantized TNS coefficients -> direct-form LPC (spec 4.6.9.3)."""
    coef_res = f["coef_res"]
    bits = coef_res + 3 - f["compress"]
    rng = 1 << (bits - 1)
    iqfac = ((1 << (coef_res + 3 - 1)) - 0.5) / (np.pi / 2.0)
    iqfac_m = ((1 << (coef_res + 3 - 1)) + 0.5) / (np.pi / 2.0)
    refl = []
    for c in f["coefs"]:
        v = c - 2 * rng if c >= rng else c          # sign-extend
        refl.append(np.sin(v / (iqfac if v >= 0 else iqfac_m)))
    # reflection -> direct form (Levinson-Durbin style recursion)
    a = np.zeros(f["order"] + 1)
    a[0] = 1.0
    for m in range(1, f["order"] + 1):
        b = a.copy()
        for i in range(1, m):
            b[i] = a[i] + refl[m - 1] * a[m - i]
        b[m] = refl[m - 1]
        a = b
    return a


def _apply_tns(spec: np.ndarray, ics: IcsInfo, tns: dict,
               sr_index: int) -> None:
    short = ics.window_sequence == EIGHT_SHORT_SEQUENCE
    tns_max = (T.TNS_MAX_BANDS_128 if short else T.TNS_MAX_BANDS_1024)[sr_index]
    wlen = 128 if short else 1024
    for w, filters in enumerate(tns["windows"]):
        bottom = ics.num_swb
        for f in filters:
            top = bottom
            bottom = max(top - f["length"], 0)
            if not f["order"]:
                continue
            lpc = _tns_lpc(f)
            start_b = min(bottom, tns_max, ics.max_sfb)
            end_b = min(top, tns_max, ics.max_sfb)
            start = ics.swb_offset[start_b]
            end = ics.swb_offset[end_b]
            if end <= start:
                continue
            sl = spec[w * wlen + start: w * wlen + end]
            order = f["order"]
            if f.get("direction"):
                for i in range(len(sl) - 2, -1, -1):
                    acc = sl[i]
                    for k in range(1, min(order, len(sl) - 1 - i) + 1):
                        acc -= lpc[k] * sl[i + k]
                    sl[i] = acc
            else:
                for i in range(1, len(sl)):
                    acc = sl[i]
                    for k in range(1, min(order, i) + 1):
                        acc -= lpc[k] * sl[i - k]
                    sl[i] = acc


def _parse_spectral(r: BitReader, ics: IcsInfo, books: list[int]) -> np.ndarray:
    """Huffman-decode quantized levels -> (1024,) in deinterleaved
    (per-window) order."""
    quant = np.zeros(1024, np.int32)
    wlen = 128 if ics.window_sequence == EIGHT_SHORT_SEQUENCE else 1024
    win_base = 0
    for g, glen in enumerate(ics.group_len[: ics.num_window_groups]):
        for b in range(ics.max_sfb):
            cb = books[g * ics.max_sfb + b]
            lo, hi = ics.swb_offset[b], ics.swb_offset[b + 1]
            width = hi - lo
            if cb in (H.ZERO_HCB, H.NOISE_HCB, H.INTENSITY_HCB,
                      H.INTENSITY_HCB2):
                continue
            dim = H.BOOK_INFO[cb][0]
            for w in range(glen):
                dst = (win_base + w) * wlen + lo
                i = 0
                while i < width:
                    vals = H.read_group(r, cb)
                    quant[dst + i: dst + i + dim] = vals
                    i += dim
        win_base += glen
    return quant


def _dequantize(ch: ChannelData, sr_index: int) -> np.ndarray:
    ics = ch.ics
    wlen = 128 if ics.window_sequence == EIGHT_SHORT_SEQUENCE else 1024
    q = ch.quant.astype(np.float64)
    spec = np.sign(q) * np.abs(q) ** (4.0 / 3.0)
    win_base = 0
    for g, glen in enumerate(ics.group_len[: ics.num_window_groups]):
        for b in range(ics.max_sfb):
            idx = g * ics.max_sfb + b
            cb = ch.band_books[idx]
            lo, hi = ics.swb_offset[b], ics.swb_offset[b + 1]
            if cb in (H.INTENSITY_HCB, H.INTENSITY_HCB2):
                continue                       # filled from left channel later
            if cb == H.NOISE_HCB:
                continue                       # filled in PNS stage
            if cb == H.ZERO_HCB:
                continue
            gain = 2.0 ** (0.25 * (ch.scalefactors[idx] - SF_OFFSET))
            for w in range(glen):
                s = (win_base + w) * wlen
                spec[s + lo: s + hi] *= gain
        win_base += glen
    return spec


def _apply_pns(ch: ChannelData, spec: np.ndarray, rng: np.random.Generator
               ) -> None:
    ics = ch.ics
    wlen = 128 if ics.window_sequence == EIGHT_SHORT_SEQUENCE else 1024
    win_base = 0
    for g, glen in enumerate(ics.group_len[: ics.num_window_groups]):
        for b in range(ics.max_sfb):
            idx = g * ics.max_sfb + b
            if ch.band_books[idx] != H.NOISE_HCB:
                continue
            lo, hi = ics.swb_offset[b], ics.swb_offset[b + 1]
            target = 2.0 ** (0.5 * (ch.scalefactors[idx] - SF_OFFSET))
            for w in range(glen):
                s = (win_base + w) * wlen
                noise = rng.normal(0.0, 1.0, hi - lo)
                norm = np.sqrt(np.sum(noise * noise)) or 1.0
                spec[s + lo: s + hi] = noise / norm * np.sqrt(target * (hi - lo))
        win_base += glen


@dataclass
class _ChannelState:
    overlap: np.ndarray = field(default_factory=lambda: np.zeros(1024))
    prev_shape: int = 0


class AacDecoder:
    """Stateful LC decoder: feed raw_data_block payloads, get PCM."""

    def __init__(self, config: AacConfig):
        if config.object_type != 2:
            raise AacDecodeError(f"AOT {config.object_type} not supported (LC only)")
        self.config = config
        self.sr_index = config.sr_index
        self._state = [_ChannelState() for _ in range(max(config.channels, 2))]
        self._noise_rng = np.random.default_rng(0x5EED)

    # -- element parsing ---------------------------------------------------
    def _parse_ics(self, r: BitReader, common_ics: IcsInfo | None) -> ChannelData:
        global_gain = r.read_bits(8)
        ics = common_ics or _parse_ics_info(r, self.sr_index)
        ch = ChannelData(ics=ics, global_gain=global_gain)
        ch.band_books = _parse_section_data(r, ics)
        ch.scalefactors = _parse_scale_factors(r, ics, ch.band_books,
                                               global_gain)
        pulse = None
        if r.read_bit():
            if ics.window_sequence == EIGHT_SHORT_SEQUENCE:
                raise AacDecodeError("pulse data with short windows")
            pulse = _parse_pulse(r)
        ch.tns = _parse_tns(r, ics) if r.read_bit() else None
        if r.read_bit():
            raise AacDecodeError("gain_control not supported")
        ch.quant = _parse_spectral(r, ics, ch.band_books)
        if pulse:
            base = ics.swb_offset[pulse["start_sfb"]]
            k = base
            for off, amp in zip(pulse["offsets"], pulse["amps"]):
                k += off
                if k < 1024:
                    q = ch.quant[k]
                    ch.quant[k] = q + amp if q >= 0 else q - amp
        return ch

    def _finish_channel(self, ch: ChannelData, spec: np.ndarray,
                        ch_index: int) -> np.ndarray:
        if ch.tns:
            _apply_tns(spec, ch.ics, ch.tns, self.sr_index)
        return self._filterbank(spec, ch.ics, ch_index)

    # -- filterbank --------------------------------------------------------
    def _filterbank(self, spec: np.ndarray, ics: IcsInfo, ci: int
                    ) -> np.ndarray:
        st = self._state[ci]
        seq = ics.window_sequence
        shape = ics.window_shape
        prev = st.prev_shape
        out = np.zeros(1024)
        if seq in (ONLY_LONG_SEQUENCE, LONG_START_SEQUENCE,
                   LONG_STOP_SEQUENCE):
            x = inverse_mdct(spec)                      # (2048,)
            # first half window: prev frame's shape; transitions per spec
            if seq == LONG_STOP_SEQUENCE:
                rise = np.concatenate([
                    np.zeros(448), window_halves(prev, 256)[0], np.ones(576)])
            else:
                rise = window_halves(prev, 2048)[0]
            if seq == LONG_START_SEQUENCE:
                fall = np.concatenate([
                    np.ones(576), window_halves(shape, 256)[1], np.zeros(448)])
            else:
                fall = window_halves(shape, 2048)[1]
            first = x[:1024] * rise
            second = x[1024:] * fall
            out = st.overlap + first
            st.overlap = second
        elif seq == EIGHT_SHORT_SEQUENCE:
            acc = np.zeros(2048)
            rise0 = window_halves(prev, 256)[0]
            for w in range(8):
                xw = inverse_mdct(spec[w * 128:(w + 1) * 128])   # (256,)
                rise = rise0 if w == 0 else window_halves(shape, 256)[0]
                fall = window_halves(shape, 256)[1]
                start = 448 + w * 128
                acc[start:start + 256] += np.concatenate(
                    [xw[:128] * rise, xw[128:] * fall])
            out = st.overlap + acc[:1024]
            st.overlap = acc[1024:]
        else:
            raise AacDecodeError(f"bad window sequence {seq}")
        st.prev_shape = shape
        return out

    # -- public ------------------------------------------------------------
    def decode_frame(self, payload: bytes) -> np.ndarray:
        """One raw_data_block -> (channels, 1024) float PCM in [-1, 1)."""
        r = BitReader(payload)
        outs: list[np.ndarray] = []
        while True:
            ele = r.read_bits(3)
            if ele == 7:                                   # END
                break
            if ele in (0, 3):                              # SCE / LFE
                r.read_bits(4)                             # element id
                ch = self._parse_ics(r, None)
                spec = _dequantize(ch, self.sr_index)
                _apply_pns(ch, spec, self._noise_rng)
                outs.append(self._finish_channel(ch, spec, len(outs)))
            elif ele == 1:                                 # CPE
                r.read_bits(4)
                common = r.read_bit()
                ms_mask_present = 0
                ms_used: list[int] = []
                ics = None
                if common:
                    ics = _parse_ics_info(r, self.sr_index)
                    ms_mask_present = r.read_bits(2)
                    if ms_mask_present == 1:
                        nb = ics.num_window_groups * ics.max_sfb
                        ms_used = [r.read_bit() for _ in range(nb)]
                left = self._parse_ics(r, ics)
                right = self._parse_ics(r, ics)
                ls = _dequantize(left, self.sr_index)
                rs = _dequantize(right, self.sr_index)
                _apply_pns(left, ls, self._noise_rng)
                _apply_pns(right, rs, self._noise_rng)
                self._stereo_tools(left, right, ls, rs, ms_mask_present,
                                   ms_used)
                outs.append(self._finish_channel(left, ls, len(outs)))
                outs.append(self._finish_channel(right, rs, len(outs)))
            elif ele == 4:                                 # DSE
                r.read_bits(4)
                align = r.read_bit()
                cnt = r.read_bits(8)
                if cnt == 255:
                    cnt += r.read_bits(8)
                if align:
                    r.byte_align()
                for _ in range(cnt):
                    r.read_bits(8)
            elif ele == 6:                                 # FIL
                cnt = r.read_bits(4)
                if cnt == 15:
                    cnt += r.read_bits(8) - 1
                for _ in range(cnt):
                    r.read_bits(8)
            else:
                raise AacDecodeError(f"unsupported syntactic element {ele}")
        # scale to [-1, 1): spec PCM is full-scale int16-ish after /32768
        return np.stack(outs) / 32768.0 if outs else np.zeros((0, 1024))

    def _stereo_tools(self, left: ChannelData, right: ChannelData,
                      ls: np.ndarray, rs: np.ndarray, ms_mask_present: int,
                      ms_used: list[int]) -> None:
        ics = left.ics
        wlen = 128 if ics.window_sequence == EIGHT_SHORT_SEQUENCE else 1024
        win_base = 0
        for g, glen in enumerate(ics.group_len[: ics.num_window_groups]):
            for b in range(ics.max_sfb):
                idx = g * ics.max_sfb + b
                lo, hi = ics.swb_offset[b], ics.swb_offset[b + 1]
                rcb = right.band_books[idx] if idx < len(right.band_books) else 0
                is_band = rcb in (H.INTENSITY_HCB, H.INTENSITY_HCB2)
                ms_band = (ms_mask_present == 2
                           or (ms_mask_present == 1 and idx < len(ms_used)
                               and ms_used[idx]))
                for w in range(glen):
                    s = (win_base + w) * wlen
                    sl = slice(s + lo, s + hi)
                    if is_band:
                        sign = -1.0 if rcb == H.INTENSITY_HCB2 else 1.0
                        if ms_mask_present == 1 and idx < len(ms_used) \
                                and ms_used[idx]:
                            sign = -sign
                        scale = 0.5 ** (0.25 * right.scalefactors[idx])
                        rs[sl] = sign * scale * ls[sl]
                    elif ms_band:
                        m = ls[sl].copy()
                        sdiff = rs[sl].copy()
                        ls[sl] = m + sdiff
                        rs[sl] = m - sdiff
            win_base += glen


def decode_adts(data: bytes) -> tuple[AacConfig, np.ndarray]:
    """Whole ADTS stream -> (config, (channels, n_samples) float PCM)."""
    from vlog_tpu_torch.codecs.aac.adts import split_adts

    cfg, frames = split_adts(data)
    dec = AacDecoder(cfg)
    chunks = [dec.decode_frame(f) for f in frames]
    return cfg, np.concatenate(chunks, axis=1) if chunks else np.zeros((0, 0))
