"""AAC spectral/scalefactor Huffman coding (ISO/IEC 14496-3 4.6.3) (copy of
``vlog_tpu/codecs/aac/huffman.py``).

Codeword tables are the normative constants in ``tables.py``; this module
adds the codebook *semantics*: index <-> coefficient-tuple mapping,
sign-bit handling for the unsigned books, and the book-11 escape
sequence, bits -> values for the decoder (the encoder's writers are not
copied).

Codebook inventory (Table 4.A.1): books 1-2 quad signed LAV=1, 3-4 quad
unsigned LAV=2, 5-6 pair signed LAV=4, 7-8 pair unsigned LAV=7, 9-10
pair unsigned LAV=12, 11 pair unsigned escape LAV=16(esc).
"""

from __future__ import annotations

from vlog_tpu_torch.codecs.aac import tables as T
from vlog_tpu_torch.media.bitstream import BitReader

ZERO_HCB = 0
FIRST_PAIR_HCB = 5
ESC_HCB = 11
NOISE_HCB = 13
INTENSITY_HCB2 = 14
INTENSITY_HCB = 15

# (dimension, signed, LAV) per book 1..11
BOOK_INFO = {
    1: (4, True, 1), 2: (4, True, 1),
    3: (4, False, 2), 4: (4, False, 2),
    5: (2, True, 4), 6: (2, True, 4),
    7: (2, False, 7), 8: (2, False, 7),
    9: (2, False, 12), 10: (2, False, 12),
    11: (2, False, 16),
}


def book_values(book: int, idx: int) -> tuple[int, ...]:
    """Codeword index -> coefficient tuple (inverse of book_index)."""
    if book <= 2:
        return (idx // 27 - 1, (idx // 9) % 3 - 1, (idx // 3) % 3 - 1,
                idx % 3 - 1)
    if book <= 4:
        return (idx // 27, (idx // 9) % 3, (idx // 3) % 3, idx % 3)
    if book <= 6:
        return (idx // 9 - 4, idx % 9 - 4)
    if book <= 8:
        return (idx // 8, idx % 8)
    if book <= 10:
        return (idx // 13, idx % 13)
    return (idx // 17, idx % 17)


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

class _Tree:
    """Flat prefix-decode map: (length, code) -> index."""

    __slots__ = ("by_len",)

    def __init__(self, codes, bits):
        self.by_len: dict[int, dict[int, int]] = {}
        for idx, (c, b) in enumerate(zip(codes, bits)):
            self.by_len.setdefault(b, {})[c] = idx

    def read(self, r: BitReader) -> int:
        code = 0
        length = 0
        for _ in range(20):            # max codeword length is 19 (sf book)
            code = (code << 1) | r.read_bit()
            length += 1
            hit = self.by_len.get(length)
            if hit is not None and code in hit:
                return hit[code]
        raise ValueError("bad Huffman codeword")


_SPECTRAL_TREES = [
    _Tree(T.SPECTRAL_CODES[i], T.SPECTRAL_BITS[i]) for i in range(11)
]
_SF_TREE = _Tree(T.SCALEFACTOR_CODE, T.SCALEFACTOR_BITS)


def read_scalefactor(r: BitReader) -> int:
    """Returns the dpcm value in [-60, 60]."""
    return _SF_TREE.read(r) - 60


def _read_escape(r: BitReader) -> int:
    n = 4
    while r.read_bit() == 1:
        n += 1
    return (1 << n) + r.read_bits(n)


def read_group(r: BitReader, book: int) -> tuple[int, ...]:
    """Decode one codeword (+signs, +escapes) -> coefficient tuple."""
    dim, signed, lav = BOOK_INFO[book]
    idx = _SPECTRAL_TREES[book - 1].read(r)
    vals = list(book_values(book, idx))
    if not signed:
        for i, v in enumerate(vals):
            if v != 0 and r.read_bit():
                vals[i] = -v
        if book == ESC_HCB:
            for i, v in enumerate(vals):
                if abs(v) == 16:
                    mag = _read_escape(r)
                    vals[i] = -mag if v < 0 else mag
    return tuple(vals)
