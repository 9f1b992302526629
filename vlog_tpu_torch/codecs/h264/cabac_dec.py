"""H.264 CABAC decode for the first-party decoder (I16x16 / P_L0_16x16;
copy of ``vlog_tpu/codecs/h264/cabac_dec.py``, pure Python like it).

Mirror image of cabac_enc.py so the framework's own CABAC streams stay
inside the first-party decode envelope (self-transcode, sprites,
segment verification) without falling back to the libav shim. The
context derivations and neighbor grids are the same shapes as the
encoder's; the arithmetic decoder is spec 9.3.3.2.

Outputs the same levels dicts as the CAVLC decode paths, with the same
envelope validations (vertical-scan prediction layout, zero qp_delta).
"""

from __future__ import annotations

import numpy as np

from vlog_tpu_torch.codecs.h264.cabac_arith_tables import (
    RANGE_TAB_LPS,
    TRANS_IDX_LPS,
    TRANS_IDX_MPS,
)
from vlog_tpu_torch.codecs.h264.cabac_enc import (
    _CBF_BASE,
    _CBF_CAT,
    _LAST_BASE,
    _LVL_BASE,
    _LVL_CAT,
    _SIG_BASE,
    _SIGLAST_CAT,
    _SliceState,
    cbf_ctx_inc,
    init_states_264,
)
from vlog_tpu_torch.codecs.h264.cavlc import _BLK44, MvPredictor
from vlog_tpu_torch.codecs.h264.cavlc_tables import LUMA_BLOCK_ORDER, ZIGZAG_4x4

_ZZ16 = [r * 4 + c for r, c in ZIGZAG_4x4]
_UNZZ = np.argsort(_ZZ16)


def _unzigzag16(scan: np.ndarray) -> np.ndarray:
    return np.asarray(scan)[_UNZZ].reshape(4, 4)


class CabacDecodeError(ValueError):
    pass


class H264CabacDecoder:
    """Arithmetic decoding engine (9.3.3.2) over a byte buffer."""

    def __init__(self, data: bytes, slice_qp: int, *, i_slice: bool,
                 cabac_init_idc: int = 0) -> None:
        self.pstate, self.mps = init_states_264(
            slice_qp, i_slice=i_slice, cabac_init_idc=cabac_init_idc)
        self.data = data
        self.pos = 0
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._bit()

    def _bit(self) -> int:
        byte = self.data[self.pos >> 3] if (self.pos >> 3) < len(
            self.data) else 0
        bit = (byte >> (7 - (self.pos & 7))) & 1
        self.pos += 1
        return bit

    def decode_bin(self, ctx: int) -> int:
        p = self.pstate[ctx]
        rlps = RANGE_TAB_LPS[p][(self.range >> 6) & 3]
        self.range -= rlps
        if self.offset >= self.range:
            bin_val = 1 - self.mps[ctx]
            self.offset -= self.range
            self.range = rlps
            if p == 0:
                self.mps[ctx] ^= 1
            self.pstate[ctx] = TRANS_IDX_LPS[p]
        else:
            bin_val = self.mps[ctx]
            self.pstate[ctx] = TRANS_IDX_MPS[p]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return bin_val

    def decode_bypass(self) -> int:
        self.offset = (self.offset << 1) | self._bit()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def decode_terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._bit()
        return 0

    def eg_bypass(self, k: int) -> int:
        value = 0
        while self.decode_bypass():
            value += 1 << k
            k += 1
        for i in range(k - 1, -1, -1):
            value += self.decode_bypass() << i
        return value


class _Reader:
    """Residual + MB-layer parse, mirroring cabac_enc's derivations."""

    def __init__(self, c: H264CabacDecoder, mbh: int, mbw: int):
        self.c = c
        self.st = _SliceState(mbh, mbw)

    def cbf_inc(self, cat, my, mx, comp, by, bx, cur_intra):
        return cbf_ctx_inc(self.st, cat, my, mx, comp, by, bx, cur_intra)

    def residual_block(self, cat: int, n: int, my: int, mx: int, *,
                       comp: int = 0, by: int = 0, bx: int = 0,
                       cur_intra: bool = True) -> np.ndarray:
        c = self.c
        coeffs = np.zeros(n, np.int32)
        ctx = _CBF_BASE + _CBF_CAT[cat] + self.cbf_inc(
            cat, my, mx, comp, by, bx, cur_intra)
        if not c.decode_bin(ctx):
            return coeffs
        sig = []
        for i in range(n - 1):
            inc = min(i, 2) if cat == 3 else i
            if c.decode_bin(_SIG_BASE + _SIGLAST_CAT[cat] + inc):
                sig.append(i)
                if c.decode_bin(_LAST_BASE + _SIGLAST_CAT[cat] + inc):
                    break
        else:
            sig.append(n - 1)       # reached the end: last pos implicit
        num_eq1 = 0
        num_gt1 = 0
        for i in reversed(sig):
            base = _LVL_BASE + _LVL_CAT[cat]
            inc0 = 0 if num_gt1 > 0 else min(4, 1 + num_eq1)
            val = c.decode_bin(base + inc0)
            if val:
                inc_gt = 5 + min(4, num_gt1)
                mag = 1
                while mag < 14 and c.decode_bin(base + inc_gt):
                    mag += 1
                if mag == 14:
                    mag += c.eg_bypass(0)
                num_gt1 += 1
            else:
                mag = 0
                num_eq1 += 1
            level = mag + 1
            if c.decode_bypass():
                level = -level
            coeffs[i] = level
        return coeffs


def decode_slice_data_cabac(data: bytes, sps, header) -> dict:
    """CABAC I-slice counterpart of decoder.decode_slice_data."""
    from vlog_tpu_torch.codecs.h264.decoder import UnsupportedStream

    mbh, mbw = sps.mb_height, sps.mb_width
    if header.first_mb != 0:
        raise UnsupportedStream("multi-slice pictures not supported")
    c = H264CabacDecoder(data, header.qp, i_slice=True)
    rd = _Reader(c, mbh, mbw)
    st = rd.st
    luma_dc = np.zeros((mbh, mbw, 4, 4), np.int32)
    luma_ac = np.zeros((mbh, mbw, 4, 4, 4, 4), np.int32)
    chroma_dc = np.zeros((2, mbh, mbw, 2, 2), np.int32)
    chroma_ac = np.zeros((2, mbh, mbw, 2, 2, 4, 4), np.int32)

    for my in range(mbh):
        for mx in range(mbw):
            ca = 1 if mx > 0 else 0
            cb = 1 if my > 0 else 0
            if not c.decode_bin(3 + ca + cb):
                raise UnsupportedStream("I_4x4 outside decode envelope")
            if c.decode_terminate():
                raise UnsupportedStream("I_PCM outside decode envelope")
            cbp_luma = 15 if c.decode_bin(6) else 0
            cbp_chroma = 0
            if c.decode_bin(7):
                cbp_chroma = 2 if c.decode_bin(8) else 1
            luma_mode = (c.decode_bin(9) << 1) | c.decode_bin(10)
            ia = 1 if mx > 0 and st.chroma_mode[my, mx - 1] != 0 else 0
            ib = 1 if my > 0 and st.chroma_mode[my - 1, mx] != 0 else 0
            chroma_mode = 0
            if c.decode_bin(64 + ia + ib):
                chroma_mode = 1
                if c.decode_bin(67):
                    chroma_mode = 2
                    if c.decode_bin(67):
                        chroma_mode = 3
            exp_luma = 2 if my == 0 else 0
            exp_chroma = 0 if my == 0 else 2
            if luma_mode != exp_luma or chroma_mode != exp_chroma:
                raise UnsupportedStream(
                    f"prediction layout mismatch at MB ({my},{mx})")
            inc = 1 if st.prev_qp_delta_nz else 0
            if c.decode_bin(60 + inc):
                raise UnsupportedStream("mb_qp_delta != 0 not supported")
            st.prev_qp_delta_nz = False

            sc = rd.residual_block(0, 16, my, mx)
            st.cbf_lumadc[my, mx] = int(np.any(sc))
            luma_dc[my, mx] = _unzigzag16(sc)
            if cbp_luma:
                for by, bx in LUMA_BLOCK_ORDER:
                    sc = rd.residual_block(1, 15, my, mx, by=by, bx=bx)
                    full = np.zeros(16, np.int32)
                    full[1:] = sc
                    luma_ac[my, mx, by, bx] = _unzigzag16(full)
                    st.cbf_luma44[my * 4 + by, mx * 4 + bx] = int(
                        np.any(sc))
            if cbp_chroma > 0:
                for comp in range(2):
                    dc = rd.residual_block(3, 4, my, mx, comp=comp)
                    chroma_dc[comp, my, mx] = dc.reshape(2, 2)
                    st.cbf_chdc[comp, my, mx] = int(np.any(dc))
            if cbp_chroma == 2:
                for comp in range(2):
                    for by in range(2):
                        for bx in range(2):
                            sc = rd.residual_block(4, 15, my, mx,
                                                   comp=comp, by=by, bx=bx)
                            full = np.zeros(16, np.int32)
                            full[1:] = sc
                            chroma_ac[comp, my, mx, by, bx] = _unzigzag16(
                                full)
                            st.cbf_ch44[comp, my * 2 + by,
                                        mx * 2 + bx] = int(np.any(sc))
            st.intra[my, mx] = True
            st.i16[my, mx] = True
            st.chroma_mode[my, mx] = chroma_mode
            last = c.decode_terminate()
            if last != (1 if my == mbh - 1 and mx == mbw - 1 else 0):
                raise UnsupportedStream("end_of_slice_flag misplaced")
    return {"luma_dc": luma_dc, "luma_ac": luma_ac,
            "chroma_dc": chroma_dc, "chroma_ac": chroma_ac}


def decode_p_slice_data_cabac(data: bytes, sps, header) -> dict:
    """CABAC P-slice counterpart of decoder.decode_p_slice_data."""
    from vlog_tpu_torch.codecs.h264.decoder import UnsupportedStream

    mbh, mbw = sps.mb_height, sps.mb_width
    if header.first_mb != 0:
        raise UnsupportedStream("multi-slice pictures not supported")
    c = H264CabacDecoder(data, header.qp, i_slice=False)
    rd = _Reader(c, mbh, mbw)
    st = rd.st
    luma = np.zeros((mbh, mbw, 4, 4, 4, 4), np.int32)
    chroma_dc = np.zeros((2, mbh, mbw, 2, 2), np.int32)
    chroma_ac = np.zeros((2, mbh, mbw, 2, 2, 4, 4), np.int32)
    mvp = MvPredictor(mbh, mbw)
    cbp8 = np.zeros((mbh * 2, mbw * 2), np.int32)

    for my in range(mbh):
        for mx in range(mbw):
            ca = 1 if mx > 0 and not st.skip[my, mx - 1] else 0
            cb = 1 if my > 0 and not st.skip[my - 1, mx] else 0
            if c.decode_bin(11 + ca + cb):
                mvp.mvs[my, mx] = mvp.skip_mv(my, mx)
                st.skip[my, mx] = True
                if c.decode_terminate() != (
                        1 if my == mbh - 1 and mx == mbw - 1 else 0):
                    raise UnsupportedStream("end_of_slice misplaced")
                continue
            if c.decode_bin(14) or c.decode_bin(15) or c.decode_bin(16):
                raise UnsupportedStream(
                    "P mb_type outside P_L0_16x16 envelope")
            pmx, pmy = mvp.mv_pred(my, mx)
            mvd = [0, 0]
            for comp, base in ((0, 40), (1, 47)):
                amvd = 0
                if mx > 0:
                    amvd += int(st.mvd[my, mx - 1, comp])
                if my > 0:
                    amvd += int(st.mvd[my - 1, mx, comp])
                inc = 0 if amvd < 3 else (1 if amvd <= 32 else 2)
                if c.decode_bin(base + inc):
                    val = 1
                    while val < 9 and c.decode_bin(base + 2 + min(val, 4)):
                        val += 1
                    if val == 9:
                        val += c.eg_bypass(3)
                    if c.decode_bypass():
                        val = -val
                else:
                    val = 0
                mvd[comp] = val
                st.mvd[my, mx, comp] = abs(val)
            mvx, mvy = pmx + mvd[0], pmy + mvd[1]
            mvp.mvs[my, mx] = (mvx, mvy)

            cbp = 0
            for i8 in range(4):
                gy, gx = _BLK44[i8]
                y8, x8 = my * 2 + gy, mx * 2 + gx
                a = 1 if x8 > 0 and cbp8[y8, x8 - 1] == 0 else 0
                b = 1 if y8 > 0 and cbp8[y8 - 1, x8] == 0 else 0
                bit = c.decode_bin(73 + a + 2 * b)
                cbp |= bit << i8
                cbp8[y8, x8] = bit
            ca = 1 if mx > 0 and st.cbp_chroma[my, mx - 1] != 0 else 0
            cb = 1 if my > 0 and st.cbp_chroma[my - 1, mx] != 0 else 0
            cbp_chroma = 0
            if c.decode_bin(77 + ca + 2 * cb):
                ca = 1 if mx > 0 and st.cbp_chroma[my, mx - 1] == 2 else 0
                cb = 1 if my > 0 and st.cbp_chroma[my - 1, mx] == 2 else 0
                cbp_chroma = 2 if c.decode_bin(81 + ca + 2 * cb) else 1
            st.cbp_chroma[my, mx] = cbp_chroma

            if cbp or cbp_chroma:
                inc = 1 if st.prev_qp_delta_nz else 0
                if c.decode_bin(60 + inc):
                    raise UnsupportedStream("mb_qp_delta != 0")
                st.prev_qp_delta_nz = False
                for i8 in range(4):
                    oy, ox = _BLK44[i8]
                    for dy, dx in _BLK44:
                        by, bx = 2 * oy + dy, 2 * ox + dx
                        if not (cbp >> i8) & 1:
                            st.cbf_luma44[my * 4 + by, mx * 4 + bx] = 0
                            continue
                        sc = rd.residual_block(2, 16, my, mx, by=by,
                                               bx=bx, cur_intra=False)
                        luma[my, mx, by, bx] = _unzigzag16(sc)
                        st.cbf_luma44[my * 4 + by, mx * 4 + bx] = int(
                            np.any(sc))
                if cbp_chroma > 0:
                    for comp in range(2):
                        dc = rd.residual_block(3, 4, my, mx, comp=comp,
                                               cur_intra=False)
                        chroma_dc[comp, my, mx] = dc.reshape(2, 2)
                        st.cbf_chdc[comp, my, mx] = int(np.any(dc))
                for comp in range(2):
                    for by in range(2):
                        for bx in range(2):
                            if cbp_chroma != 2:
                                st.cbf_ch44[comp, my * 2 + by,
                                            mx * 2 + bx] = 0
                                continue
                            sc = rd.residual_block(4, 15, my, mx,
                                                   comp=comp, by=by,
                                                   bx=bx, cur_intra=False)
                            full = np.zeros(16, np.int32)
                            full[1:] = sc
                            chroma_ac[comp, my, mx, by, bx] = _unzigzag16(
                                full)
                            st.cbf_ch44[comp, my * 2 + by,
                                        mx * 2 + bx] = int(np.any(sc))
            if c.decode_terminate() != (
                    1 if my == mbh - 1 and mx == mbw - 1 else 0):
                raise UnsupportedStream("end_of_slice misplaced")
    return {"luma": luma, "chroma_dc": chroma_dc, "chroma_ac": chroma_ac,
            "mv_q": np.ascontiguousarray(mvp.mvs)}
