"""Per-rung HEVC encoder: parameter sets, the hvcC record and RFC 6381
string, and the entropy coding of device levels (port of
``vlog_tpu/codecs/hevc/api.py``).

The DSP runs on the encoder's ``device`` (core.py); entropy runs on the
host, one frame per thread: the native C coder (native/hevc_cabac.c) for
I slices and all-2Nx2N P slices, the Python ``PSliceWriter`` for P
slices with 2NxN/Nx2N CUs (the only coder of those). There is no Python
fallback for what the C coder covers: a failed build or a failed call
raises.
"""

from __future__ import annotations

import ctypes
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from vlog_tpu_torch.codecs.hevc import syntax
from vlog_tpu_torch.codecs.hevc.core import PART_2Nx2N, PART_Nx2N
from vlog_tpu_torch.codecs.hevc.pslice import PSliceWriter, p_nal
from vlog_tpu_torch.device import resolve_device
from vlog_tpu_torch.native.build import get_lib

CTB = syntax.CTB
_I16P = ctypes.POINTER(ctypes.c_int16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


@dataclass
class EncodedFrame:
    sample: bytes        # 4-byte-length-prefixed NAL (hvc1 sample format)
    annexb: bytes
    is_idr: bool
    psnr_y: float


def _u8(v):
    return bytes([v & 0xFF])


def _u16(v):
    return v.to_bytes(2, "big")


def hvcc_config(vps: syntax.NalUnit, sps: syntax.NalUnit,
                pps: syntax.NalUnit, level_idc: int) -> bytes:
    """HEVCDecoderConfigurationRecord (ISO 14496-15 8.3.3.1) for the
    stream shape syntax.py emits (Main profile, tier 0)."""
    out = bytearray()
    out += _u8(1)                      # configurationVersion
    out += _u8(1)                      # profile_space 0, tier 0, idc Main
    out += (0x60000000).to_bytes(4, "big")   # compat: Main + Main 10
    # constraints: progressive + non-packed + frame-only (bits 7,5,4)
    out += bytes([0xB0, 0, 0, 0, 0, 0])
    out += _u8(level_idc)
    out += _u16(0xF000)                # reserved + min_spatial_seg 0
    out += _u8(0xFC)                   # reserved + parallelismType 0
    out += _u8(0xFC | 1)               # reserved + chroma 4:2:0
    out += _u8(0xF8)                   # bit_depth_luma_minus8 = 0
    out += _u8(0xF8)                   # bit_depth_chroma_minus8 = 0
    out += _u16(0)                     # avgFrameRate unknown
    out += _u8((1 << 3) | (1 << 2) | 3)  # 1 layer, nested, 4-byte lengths
    out += _u8(3)                      # numOfArrays
    for nal in (vps, sps, pps):
        raw = nal.to_bytes()
        out += _u8(0x80 | nal.nal_type)   # array_completeness | type
        out += _u16(1) + _u16(len(raw)) + raw
    return bytes(out)


def _i16(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).reshape(-1), np.int16)


def _c_call(fn, *args) -> bytes:
    """Run one native slice coder into a buffer sized for any payload
    of its levels; a negative return is an error, not a fallback."""
    cap = max(1 << 16, args[0].size * 4)
    out = np.empty(cap, np.uint8)
    ptrs = [a.ctypes.data_as(_I16P if a.dtype == np.int16 else _I32P)
            if isinstance(a, np.ndarray) else a for a in args]
    n = fn(*ptrs, out.ctypes.data_as(_U8P), cap)
    if n < 0:
        raise RuntimeError(f"{fn.__name__} failed ({n})")
    return out[:n].tobytes()


def encode_i_payload(ly, lu, lv, rows: int, cols: int, qp: int) -> bytes:
    """I-slice CABAC payload of one frame's CTB levels (C coder)."""
    lib = get_lib()
    return _c_call(lib.vt_hevc_encode_slice, _i16(ly), _i16(lu), _i16(lv),
                   rows, cols, qp)


def encode_p_payload(ly, lu, lv, mv_cells, rows: int, cols: int,
                     qp: int) -> bytes:
    """P-slice CABAC payload of an all-2Nx2N frame (the C coder's
    contract): levels per CTB and the (2R, 2C, 2) quarter-pel MV map."""
    lib = get_lib()
    # the CTB's MV = any of its 4 identical 16-cells
    mva = np.ascontiguousarray(np.asarray(mv_cells)[::2, ::2].reshape(-1),
                               np.int32)
    scratch = np.empty(rows * cols * 2, np.int32)
    return _c_call(lib.vt_hevc_encode_p_slice, _i16(ly), _i16(lu), _i16(lv),
                   mva, rows, cols, qp, scratch)


@dataclass
class HevcEncoder:
    """Stateful per-rung encoder: frame 0 of every chain is an IDR."""

    width: int
    height: int
    fps_num: int = 30
    fps_den: int = 1
    qp: int = 30
    # None -> config.ENTROPY_THREADS
    entropy_threads: int | None = None
    deblock: bool | None = None     # None -> config.HEVC_DEBLOCK
    device: str | torch.device = "cuda"

    def __post_init__(self):
        from vlog_tpu_torch import config

        self.device = resolve_device(self.device)
        if self.entropy_threads is None:
            self.entropy_threads = config.ENTROPY_THREADS
        if self.deblock is None:
            self.deblock = config.HEVC_DEBLOCK
        self.vps = syntax.write_vps(
            syntax.level_idc_for(self.width, self.height))
        self.sps = syntax.write_sps(self.width, self.height)
        # the PPS signals what the DSP reconstructs: a decoder runs 8.7.2
        # iff this flag says so, and P prediction chains on it
        self.pps = syntax.write_pps(deblock=self.deblock)

    # ---- stream metadata -----------------------------------------------
    @property
    def hvcc_config(self) -> bytes:
        return hvcc_config(self.vps, self.sps, self.pps,
                           syntax.level_idc_for(self.width, self.height))

    @property
    def codec_string(self) -> str:
        """RFC 6381: hvc1.<profile>.<compat-reversed>.L<level>.<constraints>"""
        return f"hvc1.1.6.L{syntax.level_idc_for(self.width, self.height)}.B0"

    def headers_annexb(self) -> bytes:
        return syntax.annexb([self.vps, self.sps, self.pps])

    # ---- encoding -------------------------------------------------------
    @staticmethod
    def _pad(plane: np.ndarray, block: int) -> np.ndarray:
        b, h, w = plane.shape
        ph = (h + block - 1) // block * block
        pw = (w + block - 1) // block * block
        if (ph, pw) == (h, w):
            return plane
        return np.pad(plane, ((0, 0), (0, ph - h), (0, pw - w)), mode="edge")

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _psnr(self, recon_y: np.ndarray, src_y: np.ndarray) -> float:
        ry = recon_y[:self.height, :self.width].astype(np.float64)
        mse = np.mean((ry - src_y[:self.height, :self.width]) ** 2)
        return float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))

    def encode_chain(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     pool: ThreadPoolExecutor | None = None, *,
                     search: int = 16, chain_len: int | None = None,
                     partitions: bool | None = None,
                     frame_qps: np.ndarray | None = None
                     ) -> list[EncodedFrame]:
        """Encode one I + P chain: y (T, H, W), u/v (T, H/2, W/2) uint8.

        Frame 0 is an IDR at qp-2 (the chain anchor), frames 1..T-1 are
        P pictures against the running reconstruction; one DSP call on
        the device, then entropy per frame. ``chain_len`` pads a short
        chain with copies of its last frame (dropped from the output);
        ``frame_qps`` (length >= T) are the per-frame QPs, default
        ``self.qp``; ``partitions`` None reads config.HEVC_PARTITIONS."""
        from vlog_tpu_torch.codecs.hevc.core import encode_chain_dsp

        y = self._pad(np.asarray(y, np.uint8), CTB)
        u = self._pad(np.asarray(u, np.uint8), CTB // 2)
        v = self._pad(np.asarray(v, np.uint8), CTB // 2)
        t_real = y.shape[0]
        if chain_len is not None and t_real < chain_len:
            reps = chain_len - t_real
            y, u, v = (np.concatenate([p, np.repeat(p[-1:], reps, 0)])
                       for p in (y, u, v))
        t, h, w = y.shape
        rows, cols = h // CTB, w // CTB
        if frame_qps is None:
            fqs = np.full((t,), self.qp, np.int32)
        else:
            fqs = np.asarray(frame_qps, np.int32).reshape(-1)
            if fqs.shape[0] < t:    # tail-chain padding frames
                fqs = np.concatenate(
                    [fqs, np.full((t - fqs.shape[0],), fqs[-1], np.int32)])
        qp_i = max(10, int(fqs[0]) - 2)
        qp_p = fqs[1:] if t > 1 else np.full((1,), self.qp, np.int32)
        if partitions is None:
            from vlog_tpu_torch import config

            partitions = config.HEVC_PARTITIONS
        (intra, recon0), (p32, p16, parts, mvs, precons) = encode_chain_dsp(
            self._tensor(y[None]), self._tensor(u[None]), self._tensor(v[None]),
            search, torch.tensor([qp_i], dtype=torch.int32),
            torch.as_tensor(qp_p[None], dtype=torch.int32), partitions,
            bool(self.deblock))

        def host(a):
            return None if a is None else a[0].cpu().numpy()

        def host3(ts):
            return None if ts is None else tuple(host(a) for a in ts)

        recon_y = [host(recon0[0])] + (
            list(host(precons[0])) if precons is not None else [])
        psnrs = np.array([self._psnr(recon_y[i], y[i]) for i in range(t_real)])
        return self.entropy_chain(host3(intra), host3(p32), host3(p16),
                                  host(parts), host(mvs), fqs, rows, cols,
                                  psnrs, t_real=t_real, pool=pool)

    def entropy_chain(self, intra_np, p32_np, p16_np, parts_np, mv_np,
                      fqs, rows, cols, psnrs, t_real: int,
                      pool: ThreadPoolExecutor | None = None
                      ) -> list[EncodedFrame]:
        """Host entropy for one chain's device outputs (numpy): intra
        levels, per-P TU32 and (with partitions) TU16 levels, partition
        codes (None: all 2Nx2N), the 16-cell MV maps, the realised
        per-frame QPs ``fqs`` (slot 0 the plan value: the IDR codes at
        max(10, fqs[0] - 2)) and per-frame luma PSNR."""
        qp_i = max(10, int(fqs[0]) - 2)

        def p_payload(idx: int) -> bytes:
            l32 = tuple(a[idx] for a in p32_np)
            part = parts_np[idx] if parts_np is not None else None
            mvg = mv_np[idx]                    # (2R, 2C, 2) 16-cell map
            qp = int(fqs[idx + 1])
            if part is None or not np.any(part != PART_2Nx2N):
                return encode_p_payload(*l32, mvg, rows, cols, qp)
            # 2NxN/Nx2N CUs: the Python writer is their only coder
            l16 = tuple(a[idx] for a in p16_np)
            sw = PSliceWriter(qp, rows, cols)
            for r in range(rows):
                for c in range(cols):
                    last = r == rows - 1 and c == cols - 1
                    p = int(part[r, c])
                    if p == PART_2Nx2N:
                        sw.write_ctu_inter(
                            r, c, tuple(int(x) for x in mvg[2 * r, 2 * c]),
                            l32[0][r, c], l32[1][r, c], l32[2][r, c],
                            last_in_slice=last)
                        continue
                    vertical = p == PART_Nx2N
                    mv0 = mvg[2 * r, 2 * c]
                    mv1 = (mvg[2 * r, 2 * c + 1] if vertical
                           else mvg[2 * r + 1, 2 * c])
                    # sub-TUs in z-order from the 16-block grids
                    zs = [(2 * r, 2 * c), (2 * r, 2 * c + 1),
                          (2 * r + 1, 2 * c), (2 * r + 1, 2 * c + 1)]
                    sw.write_ctu_inter_2part(
                        r, c, vertical=vertical,
                        mv0=tuple(int(x) for x in mv0),
                        mv1=tuple(int(x) for x in mv1),
                        luma_tus=[l16[0][zy, zx] for zy, zx in zs],
                        cb_tus=[l16[1][zy, zx] for zy, zx in zs],
                        cr_tus=[l16[2][zy, zx] for zy, zx in zs],
                        last_in_slice=last)
            return sw.payload()

        def pack(i: int) -> EncodedFrame:
            if i == 0:
                nal = syntax.idr_nal(qp_i, encode_i_payload(*intra_np, rows,
                                                            cols, qp_i))
            else:
                nal = p_nal(int(fqs[i]), i, p_payload(i - 1))
            raw = nal.to_bytes()
            return EncodedFrame(
                sample=len(raw).to_bytes(4, "big") + raw,
                annexb=syntax.annexb(
                    ([self.vps, self.sps, self.pps] if i == 0 else []) + [nal]),
                is_idr=(i == 0), psnr_y=float(psnrs[i]))

        if pool is None:
            with ThreadPoolExecutor(self.entropy_threads,
                                    thread_name_prefix="vlog-entropy") as p:
                return list(p.map(pack, range(t_real)))
        return list(pool.map(pack, range(t_real)))

    def encode_batch(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                     pool: ThreadPoolExecutor | None = None,
                     frame_qps: np.ndarray | None = None
                     ) -> list[EncodedFrame]:
        """Encode a batch of frames, every one an IDR: y (B, H, W), u/v
        (B, H/2, W/2) uint8. One DSP call on the device; entropy per
        frame."""
        from vlog_tpu_torch.codecs.hevc.core import encode_frame_dsp

        y = self._pad(np.asarray(y, np.uint8), CTB)
        u = self._pad(np.asarray(u, np.uint8), CTB // 2)
        v = self._pad(np.asarray(v, np.uint8), CTB // 2)
        b, h, w = y.shape
        rows, cols = h // CTB, w // CTB
        if frame_qps is None:
            qps = np.full((b,), self.qp, np.int32)
        else:
            qps = np.asarray(frame_qps, np.int32).reshape(-1)[:b]
            if qps.shape[0] < b:    # same short-vector pad as encode_chain
                qps = np.concatenate(
                    [qps, np.full((b - qps.shape[0],), qps[-1] if qps.size
                                  else self.qp, np.int32)])
        (ly, lu, lv), (ry, _, _) = encode_frame_dsp(
            self._tensor(y), self._tensor(u), self._tensor(v),
            torch.as_tensor(qps), deblock=bool(self.deblock))
        ly, lu, lv, ry = (a.cpu().numpy() for a in (ly, lu, lv, ry))

        def pack(i: int) -> EncodedFrame:
            qp = int(qps[i])
            nal = syntax.idr_nal(qp, encode_i_payload(ly[i], lu[i], lv[i],
                                                      rows, cols, qp))
            raw = nal.to_bytes()
            return EncodedFrame(
                sample=len(raw).to_bytes(4, "big") + raw,
                annexb=syntax.annexb([self.vps, self.sps, self.pps, nal]),
                is_idr=True, psnr_y=self._psnr(ry[i], y[i]))

        if pool is None:
            with ThreadPoolExecutor(self.entropy_threads,
                                    thread_name_prefix="vlog-entropy") as p:
                return list(p.map(pack, range(b)))
        return list(pool.map(pack, range(b)))
