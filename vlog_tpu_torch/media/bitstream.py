"""MSB-first bit writer, Exp-Golomb codes and NAL emulation prevention
(copy of the writer half of ``vlog_tpu/media/bitstream.py``)."""

from __future__ import annotations

import ctypes

import numpy as np


class BitWriter:
    """MSB-first bit accumulator."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._cur = 0       # partial byte
        self._nbits = 0     # bits currently in _cur (0..7)

    def write_bit(self, bit: int) -> None:
        self._cur = (self._cur << 1) | (bit & 1)
        self._nbits += 1
        if self._nbits == 8:
            self._bytes.append(self._cur)
            self._cur = 0
            self._nbits = 0

    def write_bits(self, value: int, width: int) -> None:
        if width < 0 or (width < value.bit_length()):
            raise ValueError(f"value {value} does not fit in {width} bits")
        for i in range(width - 1, -1, -1):
            self.write_bit((value >> i) & 1)

    def write_ue(self, value: int) -> None:
        """Unsigned Exp-Golomb (H.264 9.1)."""
        if value < 0:
            raise ValueError("ue(v) requires value >= 0")
        code = value + 1
        nbits = code.bit_length()
        self.write_bits(0, nbits - 1)
        self.write_bits(code, nbits)

    def write_se(self, value: int) -> None:
        """Signed Exp-Golomb: k>0 -> 2k-1, k<=0 -> -2k."""
        self.write_ue(2 * value - 1 if value > 0 else -2 * value)

    def byte_align(self, bit: int = 0) -> None:
        while self._nbits != 0:
            self.write_bit(bit)

    def rbsp_trailing_bits(self) -> None:
        """rbsp_stop_one_bit + alignment zeros."""
        self.write_bit(1)
        self.byte_align(0)

    @property
    def bit_length(self) -> int:
        return len(self._bytes) * 8 + self._nbits

    def getvalue(self) -> bytes:
        if self._nbits != 0:
            raise ValueError("bitstream not byte-aligned; call byte_align()")
        return bytes(self._bytes)


def escape_emulation(rbsp: bytes) -> bytes:
    """Insert emulation-prevention bytes (0x000000/01/02/03 -> 0x000003xx).

    Slice payloads (> 4096 bytes) take the native coder library's loop,
    short parameter sets the Python one; both give the same bytes."""
    if len(rbsp) > 4096:
        from vlog_tpu_torch.native import get_lib

        src = np.frombuffer(rbsp, np.uint8)
        out = np.empty(len(rbsp) * 3 // 2 + 4, np.uint8)
        u8 = ctypes.POINTER(ctypes.c_uint8)
        n = get_lib().vt_escape_emulation(
            src.ctypes.data_as(u8), len(rbsp), out.ctypes.data_as(u8))
        return out[:n].tobytes()
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)
