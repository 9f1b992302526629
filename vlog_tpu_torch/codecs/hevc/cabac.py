"""CABAC arithmetic encoder for HEVC (ITU-T H.265 9.3).

HEVC entropy coding is CABAC-only (unlike H.264, where this framework
uses CAVLC — codecs/h264/cavlc.py), so this is the first-party binary
arithmetic coder: the standard low/range engine with outstanding-bit
carry resolution, context models as (pStateIdx, valMPS) pairs advanced
through the shared H.264/H.265 transition tables, bypass coding for
equiprobable bins, and the terminate bin that closes every CTU row and
the slice.

This Python implementation is the bit-exact reference the tests oracle
against libavcodec; the C port (native/hevc_cabac.c) mirrors it for
production throughput, the same split as cavlc.py / native/cavlc.c.

Reference parity: the reference never encodes HEVC on CPU — it shells
out to hevc_nvenc / hevc_vaapi (worker/hwaccel.py) — so this module is
the TPU-platform analog of those vendor encoders' entropy stage.
"""

from __future__ import annotations

from vlog_tpu_torch.codecs.hevc.tables import (
    INIT_VALUES,
    RANGE_TAB_LPS,
    TRANS_IDX_LPS,
    TRANS_IDX_MPS,
)

N_CONTEXTS = 199


def init_states(slice_qp: int, init_type: int = 0) -> tuple[list, list]:
    """ContextModel init (H.265 9.3.2.2): initValue -> (pStateIdx, valMPS).

    ``init_type`` 0 is I slices; 1/2 are P/B (cabac_init_flag permuted),
    unused until an inter path exists.
    """
    qp = min(max(slice_qp, 0), 51)
    pstate = [0] * N_CONTEXTS
    mps = [0] * N_CONTEXTS
    for i, init_value in enumerate(INIT_VALUES[init_type]):
        slope = (init_value >> 4) * 5 - 45
        offset = ((init_value & 15) << 3) - 16
        pre = min(max(((slope * qp) >> 4) + offset, 1), 126)
        if pre <= 63:
            pstate[i], mps[i] = 63 - pre, 0
        else:
            pstate[i], mps[i] = pre - 64, 1
    return pstate, mps


class ArithEncoder:
    """The shared binary arithmetic engine (identical in H.264 9.3.4 and
    H.265 9.3.4 — same range/transition tables, renorm, bypass, and
    terminate/flush). Subclasses provide the context initialization."""

    def __init__(self, pstate: list, mps: list) -> None:
        self.pstate = pstate
        self.mps = mps
        self.low = 0
        self.range = 510
        self.outstanding = 0
        self.first_bit = True
        self._bytes = bytearray()
        self._cur = 0
        self._nbits = 0

    # ---------------------------------------------------------- raw bits
    def _emit(self, bit: int) -> None:
        self._cur = (self._cur << 1) | bit
        self._nbits += 1
        if self._nbits == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._nbits = 0

    def _put_bit(self, bit: int) -> None:
        if self.first_bit:
            # the spec encoder discards the very first generated bit
            self.first_bit = False
        else:
            self._emit(bit)
        while self.outstanding > 0:
            self._emit(1 - bit)
            self.outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low >= 512:
                self._put_bit(1)
                self.low -= 512
            elif self.low < 256:
                self._put_bit(0)
            else:
                self.outstanding += 1
                self.low -= 256
            self.low <<= 1
            self.range <<= 1

    # ---------------------------------------------------------- bins
    def encode_bin(self, ctx: int, bin_val: int) -> None:
        p = self.pstate[ctx]
        rlps = RANGE_TAB_LPS[p][(self.range >> 6) & 3]
        self.range -= rlps
        if bin_val != self.mps[ctx]:
            self.low += self.range
            self.range = rlps
            if p == 0:
                self.mps[ctx] ^= 1
            self.pstate[ctx] = TRANS_IDX_LPS[p]
        else:
            self.pstate[ctx] = TRANS_IDX_MPS[p]
        self._renorm()

    def encode_bypass(self, bin_val: int) -> None:
        self.low <<= 1
        if bin_val:
            self.low += self.range
        if self.low >= 1024:
            self._put_bit(1)
            self.low -= 1024
        elif self.low < 512:
            self._put_bit(0)
        else:
            self.outstanding += 1
            self.low -= 512

    def encode_bypass_bits(self, value: int, width: int) -> None:
        for i in range(width - 1, -1, -1):
            self.encode_bypass((value >> i) & 1)

    def encode_terminate(self, bin_val: int) -> None:
        """end_of_slice_segment_flag / end_of_subset (9.3.4.3.5)."""
        self.range -= 2
        if bin_val:
            self.low += self.range
            self.range = 2
            self._flush()
        else:
            self._renorm()

    def _flush(self) -> None:
        self._renorm()
        self._put_bit((self.low >> 9) & 1)
        # WriteBits(((low >> 7) & 3) | 1, 2): the trailing 1 is the
        # rbsp_stop_one_bit of the slice data
        self._emit((self.low >> 8) & 1)
        self._emit(1)

    # ---------------------------------------------------------- output
    def getvalue(self) -> bytes:
        """Byte-aligned slice payload (after encode_terminate(1), the
        stop bit is in the stream; pad with cabac_zero-safe zeros)."""
        out = bytearray(self._bytes)
        if self._nbits:
            out.append(self._cur << (8 - self._nbits))
        return bytes(out)


class CabacEncoder(ArithEncoder):
    """H.265 contexts over the shared engine (I/P initTypes)."""

    def __init__(self, slice_qp: int, init_type: int = 0) -> None:
        super().__init__(*init_states(slice_qp, init_type))
