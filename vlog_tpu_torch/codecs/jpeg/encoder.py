"""Baseline sequential JPEG (ITU-T T.81), 4:2:0, standard Annex-K tables
(port of ``vlog_tpu/codecs/jpeg/encoder.py``).

The FDCT + quantization of every 8x8 block runs as PyTorch on the planes'
device (``dct_quantize_420``); zigzag, run-length and Huffman coding are
host bit packing in C (native/jpeg_pack.c). ``_pack_scan_python`` is the
C packer's bit-exact oracle for the tests only: a native library that
does not build or load raises, there is no fallback.

The DCT's float32 arithmetic follows what XLA's CPU compiler makes of the
JAX einsum (two dots of 8 terms, each summed as four fused multiply-add
pairs ``fma(x[k+4], m[k+4], x[k] * m[k])`` added as ``(p0 + p1) + (p2 +
p3)``, the first over the rows; the division by the quant table is a
multiplication by its float32 reciprocal), so both packages quantize to
the same levels.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from vlog_tpu_torch.codecs.h264.inter import edge_pad
from vlog_tpu_torch.ops.colorspace import rgb_to_yuv420

# ---------------------------------------------------------------------------
# Annex K tables
# ---------------------------------------------------------------------------

QUANT_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.int32)

QUANT_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], np.int32)

# Standard Huffman specs: (BITS[1..16], HUFFVAL)
DC_LUMA_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
DC_LUMA_VALS = list(range(12))
DC_CHROMA_BITS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
DC_CHROMA_VALS = list(range(12))

AC_LUMA_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
AC_LUMA_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]
AC_CHROMA_BITS = [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
AC_CHROMA_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])


def _build_huffman(bits: list[int], vals: list[int]) -> dict[int, tuple[int, int]]:
    """BITS/HUFFVAL -> {symbol: (code, length)} (T.81 C.2 canonical codes)."""
    table: dict[int, tuple[int, int]] = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table

_DC_LUMA = _build_huffman(DC_LUMA_BITS, DC_LUMA_VALS)
_DC_CHROMA = _build_huffman(DC_CHROMA_BITS, DC_CHROMA_VALS)
_AC_LUMA = _build_huffman(AC_LUMA_BITS, AC_LUMA_VALS)
_AC_CHROMA = _build_huffman(AC_CHROMA_BITS, AC_CHROMA_VALS)


def _table_arrays(tbl: dict[int, tuple[int, int]]
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Dict table -> (codes uint16[256], lens uint8[256]) for the C packer."""
    codes = np.zeros(256, np.uint16)
    lens = np.zeros(256, np.uint8)
    for sym, (code, length) in tbl.items():
        codes[sym] = code
        lens[sym] = length
    return codes, lens


_C_TABLES = tuple(_table_arrays(t) for t in
                  (_DC_LUMA, _AC_LUMA, _DC_CHROMA, _AC_CHROMA))


def _pack_scan_native(blocks: np.ndarray, comp: np.ndarray) -> bytes:
    """Entropy-code the interleaved scan in C (raises if the library
    cannot be built or loaded)."""
    from vlog_tpu_torch.native import get_lib

    lib = get_lib()
    blocks = np.ascontiguousarray(blocks, np.int32)
    comp = np.ascontiguousarray(comp, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    u16 = ctypes.POINTER(ctypes.c_uint16)
    cap = blocks.shape[0] * 128 + 64
    # the worst case is ~2x this (all-escape coefficients + byte
    # stuffing): retry with a doubled buffer
    for _ in range(3):
        out = np.empty(cap, np.uint8)
        args = [blocks.ctypes.data_as(i32), comp.ctypes.data_as(u8),
                ctypes.c_int64(blocks.shape[0])]
        for codes, lens in _C_TABLES:
            args.append(codes.ctypes.data_as(u16))
            args.append(lens.ctypes.data_as(u8))
        args += [out.ctypes.data_as(u8), ctypes.c_int64(cap)]
        n = lib.vt_jpeg_pack_scan(*args)
        if n >= 0:
            return out[:n].tobytes()
        cap *= 2
    raise RuntimeError("native JPEG scan packer overflowed its buffer")


def _pack_scan_python(blocks: np.ndarray, comp: np.ndarray) -> bytes:
    """Pure-Python scan packer: the C packer's bit-exact oracle (tests)."""
    pk = _BitPacker()
    pred = [0, 0, 0]
    for bi in range(blocks.shape[0]):
        c = int(comp[bi])
        pred[c] = _encode_block(
            pk, blocks[bi], pred[c],
            _DC_LUMA if c == 0 else _DC_CHROMA,
            _AC_LUMA if c == 0 else _AC_CHROMA)
    pk.flush()
    return bytes(pk.out)


def scaled_quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg-compatible quality (1..100) scaling of the Annex-K tables."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    out = []
    for base in (QUANT_LUMA, QUANT_CHROMA):
        t = (base * scale + 50) // 100
        out.append(np.clip(t, 1, 255).astype(np.int32))
    return out[0], out[1]


# ---------------------------------------------------------------------------
# Device half: FDCT + quantize, batched over all blocks of a plane
# ---------------------------------------------------------------------------

def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    c = np.where(k == 0, 1.0 / np.sqrt(2.0), 1.0)
    m = c[:, None] / 2.0 * np.cos((2 * np.arange(8)[None, :] + 1) * k[:, None] * np.pi / 16)
    return m.astype(np.float32)


_DCT = _dct_matrix()


def _blocks(plane: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H/8 * W/8, 8, 8) in raster block order."""
    h, w = plane.shape
    b = plane.reshape(h // 8, 8, w // 8, 8)
    return b.permute(0, 2, 1, 3).reshape(-1, 8, 8)


def _dot8(a: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``a @ m`` for a (..., 8) float32 and m (8, k) float32, summed as
    XLA's CPU dot sums 8 terms (see the module docstring)."""
    mf = m.double()
    pairs = [(a[..., k + 4, None].double() * mf[k + 4]
              + (a[..., k, None] * m[k]).double()).float() for k in range(4)]
    return (pairs[0] + pairs[1]) + (pairs[2] + pairs[3])


def dct_quantize_420(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                     quality: int):
    """Planes (uint8, 8-aligned; u/v 4:2:0) -> quantized zigzag blocks on
    the planes' device: int32 (n_blocks, 64) in zigzag order, raster
    block order per plane."""
    dev = y.device
    qy, qc = scaled_quant_tables(quality)
    dt = torch.as_tensor(_DCT.T.copy(), device=dev)      # dt[j, i] = D[i, j]
    zz = torch.as_tensor(ZIGZAG, device=dev)

    def plane_blocks(p, qtbl):
        x = _blocks(p.to(torch.float32) - 128.0)
        t = _dot8(x.transpose(-1, -2), dt).transpose(-1, -2)  # D @ x
        coef = _dot8(t, dt)                                   # (D @ x) @ D^T
        recip = torch.as_tensor(np.float32(1.0) / qtbl.astype(np.float32),
                                device=dev)
        q = torch.round(coef * recip)
        return q.to(torch.int32).reshape(-1, 64)[:, zz]

    return plane_blocks(y, qy), plane_blocks(u, qc), plane_blocks(v, qc)


# ---------------------------------------------------------------------------
# Host half: Huffman entropy coding + JFIF container
# ---------------------------------------------------------------------------

class _BitPacker:
    """MSB-first packer with JPEG 0xFF byte stuffing."""

    def __init__(self) -> None:
        self.out = bytearray()
        self._acc = 0
        self._n = 0

    def put(self, code: int, length: int) -> None:
        self._acc = (self._acc << length) | (code & ((1 << length) - 1))
        self._n += length
        while self._n >= 8:
            self._n -= 8
            byte = (self._acc >> self._n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)

    def flush(self) -> None:
        if self._n:
            pad = 8 - self._n
            self.put((1 << pad) - 1, pad)  # pad with 1s


def _magnitude(v: int) -> tuple[int, int]:
    """(size category, offset code) per T.81 F.1.2.1."""
    if v == 0:
        return 0, 0
    size = int(abs(v)).bit_length()
    code = v if v > 0 else v + (1 << size) - 1
    return size, code


def _encode_block(pk: _BitPacker, zz: np.ndarray, pred_dc: int,
                  dc_tbl: dict, ac_tbl: dict) -> int:
    dc = int(zz[0])
    size, code = _magnitude(dc - pred_dc)
    hc, hl = dc_tbl[size]
    pk.put(hc, hl)
    if size:
        pk.put(code, size)
    run = 0
    last_nz = 0
    nz = np.nonzero(zz[1:])[0]
    last_nz = int(nz[-1]) + 1 if nz.size else 0
    for i in range(1, last_nz + 1):
        v = int(zz[i])
        if v == 0:
            run += 1
            continue
        while run > 15:
            hc, hl = ac_tbl[0xF0]  # ZRL
            pk.put(hc, hl)
            run -= 16
        size, code = _magnitude(v)
        hc, hl = ac_tbl[(run << 4) | size]
        pk.put(hc, hl)
        pk.put(code, size)
        run = 0
    if last_nz < 63:
        hc, hl = ac_tbl[0x00]  # EOB
        pk.put(hc, hl)
    return dc


def _marker(tag: int, payload: bytes) -> bytes:
    return bytes([0xFF, tag]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _dqt(qy: np.ndarray, qc: np.ndarray) -> bytes:
    def one(tid, tbl):
        return bytes([tid]) + bytes(int(tbl.reshape(-1)[ZIGZAG[i]]) for i in range(64))
    return _marker(0xDB, one(0, qy) + one(1, qc))


def _sof0(w: int, h: int) -> bytes:
    payload = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([3])
    payload += bytes([1, 0x22, 0])   # Y: 2x2 sampling, qtable 0
    payload += bytes([2, 0x11, 1])   # Cb
    payload += bytes([3, 0x11, 1])   # Cr
    return _marker(0xC0, payload)


def _dht() -> bytes:
    payload = b""
    for cls, tid, bits, vals in (
        (0, 0, DC_LUMA_BITS, DC_LUMA_VALS),
        (1, 0, AC_LUMA_BITS, AC_LUMA_VALS),
        (0, 1, DC_CHROMA_BITS, DC_CHROMA_VALS),
        (1, 1, AC_CHROMA_BITS, AC_CHROMA_VALS),
    ):
        payload += bytes([(cls << 4) | tid]) + bytes(bits) + bytes(vals)
    return _marker(0xC4, payload)


def _sos() -> bytes:
    payload = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    return _marker(0xDA, payload)

_APP0 = _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _pad_to(plane: torch.Tensor, align: int) -> torch.Tensor:
    h, w = plane.shape
    return edge_pad(plane, 0, (-h) % align, 0, (-w) % align)


@dataclass(frozen=True)
class JpegBlocks:
    """One picture's quantized blocks on the host, as ``dct_quantize_420``
    returns them, and what the headers need: everything the bytes of
    ``pack_jpeg`` depend on."""

    y: np.ndarray                 # (luma blocks, 64) int32, zigzag
    u: np.ndarray
    v: np.ndarray
    padded: tuple[int, int]       # luma plane (H, W), multiples of 16
    size: tuple[int, int]         # display (h, w) in SOF0
    quality: int


def quantize_yuv420(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    *, quality: int = 85,
                    display_size: tuple[int, int] | None = None) -> JpegBlocks:
    """Full-range YCbCr 4:2:0 planes -> their quantized blocks.

    y: (H, W) uint8; u/v: (ceil(H/2), ceil(W/2)), tensors on any device
    (the DCT runs there). ``display_size`` (h, w) overrides the SOF
    dimensions when the caller pre-padded the planes."""
    y, u, v = (torch.as_tensor(p).to(torch.uint8) for p in (y, u, v))
    h, w = display_size if display_size is not None else tuple(y.shape)
    y = _pad_to(y, 16)
    u = _pad_to(u, 8)
    v = _pad_to(v, 8)
    if u.shape[0] * 2 != y.shape[0] or u.shape[1] * 2 != y.shape[1]:
        # chroma planes for odd luma sizes: pad up to half the padded luma
        uh, uw = y.shape[0] // 2, y.shape[1] // 2
        u = edge_pad(u, 0, uh - u.shape[0], 0, uw - u.shape[1])
        v = edge_pad(v, 0, uh - v.shape[0], 0, uw - v.shape[1])
    yq, uq, vq = (a.cpu().numpy()
                  for a in dct_quantize_420(y, u, v, quality=quality))
    return JpegBlocks(yq, uq, vq, padded=tuple(y.shape), size=(h, w),
                      quality=quality)


def pack_jpeg(q: JpegBlocks) -> bytes:
    """Quantized blocks -> baseline JFIF bytes: interleaved single scan,
    2x2 MCUs, the C packer."""
    qy, qc = scaled_quant_tables(q.quality)
    mcu_h, mcu_w = q.padded[0] // 16, q.padded[1] // 16
    ybw = q.padded[1] // 8                     # luma blocks per row
    cbw = mcu_w

    # Interleave blocks in MCU scan order (Y00 Y01 Y10 Y11 Cb Cr) with a
    # component id per block for the C packer.
    n_mcu = mcu_h * mcu_w
    my, mx = np.mgrid[0:mcu_h, 0:mcu_w]
    dy, dx = np.mgrid[0:2, 0:2]
    yidx = ((my[..., None, None] * 2 + dy) * ybw
            + mx[..., None, None] * 2 + dx).reshape(n_mcu, 4)
    cidx = (my * cbw + mx).reshape(n_mcu)
    blocks = np.empty((n_mcu, 6, 64), np.int32)
    blocks[:, :4] = q.y[yidx]
    blocks[:, 4] = q.u[cidx]
    blocks[:, 5] = q.v[cidx]
    blocks = blocks.reshape(n_mcu * 6, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2], np.uint8), n_mcu)

    scan = _pack_scan_native(blocks, comp)
    h, w = q.size
    return (b"\xff\xd8" + _APP0 + _dqt(qy, qc) + _sof0(w, h) + _dht() + _sos()
            + scan + b"\xff\xd9")


def encode_jpeg_yuv420(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                       *, quality: int = 85,
                       display_size: tuple[int, int] | None = None) -> bytes:
    """Full-range YCbCr 4:2:0 planes -> baseline JFIF bytes
    (``quantize_yuv420`` then ``pack_jpeg``)."""
    return pack_jpeg(quantize_yuv420(y, u, v, quality=quality,
                                     display_size=display_size))


def rgb_to_jpeg_planes(rgb: torch.Tensor):
    """(H, W, 3) uint8 RGB tensor -> the full-range BT.601 4:2:0 planes
    ``encode_jpeg_rgb`` codes (edge-padded to even dims), on the tensor's
    device."""
    arr = torch.as_tensor(rgb).to(torch.uint8)
    h, w = arr.shape[:2]
    ph, pw = (-h) % 2, (-w) % 2
    if ph or pw:  # rgb_to_yuv420 needs even dims for 2x2 chroma pooling
        arr = edge_pad(arr.permute(2, 0, 1), 0, ph, 0, pw).permute(1, 2, 0)
    # a true float32 division, as the JAX encoder's eager ``/ 255.0``: on
    # CUDA, PyTorch divides by a Python scalar as a multiplication by its
    # reciprocal, which rounds some quotients the other way; a tensor
    # divisor keeps the IEEE division on every device
    scale = torch.full((), 255.0, dtype=torch.float32, device=arr.device)
    return rgb_to_yuv420(arr.to(torch.float32) / scale, standard="bt601",
                         full_range=True)


def quantize_rgb(rgb: torch.Tensor, *, quality: int = 85) -> JpegBlocks:
    """(H, W, 3) uint8 RGB tensor -> its quantized blocks (full-range
    BT.601 conversion and the DCT on the tensor's device)."""
    h, w = rgb.shape[:2]
    return quantize_yuv420(*rgb_to_jpeg_planes(rgb), quality=quality,
                           display_size=(h, w))


def encode_jpeg_rgb(rgb: torch.Tensor, *, quality: int = 85) -> bytes:
    """(H, W, 3) uint8 RGB tensor -> JFIF bytes."""
    return pack_jpeg(quantize_rgb(rgb, quality=quality))
