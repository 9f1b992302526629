"""AAC spectral/scalefactor Huffman coding (ISO/IEC 14496-3 4.6.3) (copy of
``vlog_tpu/codecs/aac/huffman.py``).

Codeword tables are the normative constants in ``tables.py``; this module
adds the codebook *semantics*: index <-> coefficient-tuple mapping,
sign-bit handling for the unsigned books, and the book-11 escape
sequence. Used by both the encoder (value -> bits) and the decoder
(bits -> values).

Codebook inventory (Table 4.A.1): books 1-2 quad signed LAV=1, 3-4 quad
unsigned LAV=2, 5-6 pair signed LAV=4, 7-8 pair unsigned LAV=7, 9-10
pair unsigned LAV=12, 11 pair unsigned escape LAV=16(esc).
"""

from __future__ import annotations

from vlog_tpu_torch.codecs.aac import tables as T
from vlog_tpu_torch.media.bitstream import BitReader, BitWriter

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


def book_index(book: int, vals: tuple[int, ...]) -> int:
    """Coefficient tuple -> codeword index (spec 4.6.3.3 ordering)."""
    dim, signed, lav = BOOK_INFO[book]
    if book <= 2:
        w, x, y, z = vals
        return 27 * (w + 1) + 9 * (x + 1) + 3 * (y + 1) + (z + 1)
    if book <= 4:
        w, x, y, z = vals
        return 27 * w + 9 * x + 3 * y + z
    if book <= 6:
        y, z = vals
        return 9 * (y + 4) + (z + 4)
    if book <= 8:
        y, z = vals
        return 8 * vals[0] + vals[1]
    if book <= 10:
        return 13 * vals[0] + vals[1]
    return 17 * vals[0] + vals[1]


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

def write_scalefactor(w: BitWriter, dpcm: int) -> None:
    """dpcm in [-60, 60]; index = dpcm + 60 into the sf codebook."""
    idx = dpcm + 60
    if not 0 <= idx < 121:
        raise ValueError(f"scalefactor delta {dpcm} out of range")
    w.write_bits(T.SCALEFACTOR_CODE[idx], T.SCALEFACTOR_BITS[idx])


def scalefactor_bits(dpcm: int) -> int:
    return T.SCALEFACTOR_BITS[dpcm + 60]


def _write_escape(w: BitWriter, mag: int) -> None:
    """Book-11 escape: (n-4) ones, 0, then n LSBs of mag - 2^n."""
    n = mag.bit_length() - 1          # 2^n <= mag < 2^(n+1), n >= 4
    if n < 4 or n > 12:               # spec caps |coef| at 8191 (n <= 12)
        raise ValueError(f"escape magnitude {mag} out of range")
    w.write_bits((1 << (n - 4)) - 1, n - 4)
    w.write_bit(0)
    w.write_bits(mag - (1 << n), n)


def write_group(w: BitWriter, book: int, vals: tuple[int, ...]) -> None:
    """One codeword (+signs, +escapes) for a 2- or 4-tuple of quantized
    coefficients."""
    dim, signed, lav = BOOK_INFO[book]
    if signed:
        idx = book_index(book, vals)
        w.write_bits(T.SPECTRAL_CODES[book - 1][idx],
                     T.SPECTRAL_BITS[book - 1][idx])
        return
    mags = tuple(abs(v) for v in vals)
    coded = tuple(min(m, 16) for m in mags) if book == ESC_HCB else mags
    idx = book_index(book, coded)
    w.write_bits(T.SPECTRAL_CODES[book - 1][idx],
                 T.SPECTRAL_BITS[book - 1][idx])
    for v in vals:
        if v != 0:
            w.write_bit(1 if v < 0 else 0)
    if book == ESC_HCB:
        for m in mags:
            if m >= 16:
                _write_escape(w, m)


def group_bits(book: int, vals: tuple[int, ...]) -> int:
    """Exact bit cost of write_group (for codebook selection)."""
    dim, signed, lav = BOOK_INFO[book]
    if signed:
        return int(T.SPECTRAL_BITS[book - 1][book_index(book, vals)])
    mags = tuple(abs(v) for v in vals)
    coded = tuple(min(m, 16) for m in mags) if book == ESC_HCB else mags
    bits = int(T.SPECTRAL_BITS[book - 1][book_index(book, coded)])
    bits += sum(1 for v in vals if v != 0)
    if book == ESC_HCB:
        for m in mags:
            if m >= 16:
                bits += 2 * (m.bit_length() - 1) - 3
    return bits


def smallest_book(max_abs: int) -> int:
    """Cheapest codebook family that can represent |coef| <= max_abs."""
    if max_abs == 0:
        return ZERO_HCB
    if max_abs <= 1:
        return 2          # signed quad, LAV 1 (book 1/2 pair; 2 is 'noisy')
    if max_abs <= 2:
        return 4
    if max_abs <= 4:
        return 6
    if max_abs <= 7:
        return 8
    if max_abs <= 12:
        return 10
    return ESC_HCB


def best_book(vals: list[int]) -> tuple[int, int]:
    """(book, bits) minimizing exact cost over the usable books for a
    band's coefficients (vals length multiple of 4)."""
    vals = [int(v) for v in vals]
    m = max((abs(v) for v in vals), default=0)
    if m == 0:
        return ZERO_HCB, 0
    candidates = [b for b in (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11)
                  if BOOK_INFO[b][2] >= min(m, 16) or b == ESC_HCB]
    best = (ESC_HCB, None)
    for b in candidates:
        dim, signed, lav = BOOK_INFO[b]
        if b != ESC_HCB and m > lav:
            continue
        total = 0
        for i in range(0, len(vals), dim):
            total += group_bits(b, tuple(vals[i:i + dim]))
        if best[1] is None or total < best[1]:
            best = (b, total)
    return best


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
