"""Per-rung H.264 encoder object: parameter sets, frame numbering and the
entropy coding of device levels (port of ``vlog_tpu/codecs/h264/api.py``).

The device programs (parallel/ladder.py) produce levels and MVs; this
object turns them into AVCC samples (fMP4) and Annex-B access units
(MPEG-TS): one I+P chain at a time (``encode_chain``) or a batch of
intra frames (``encode_levels``). ``encode`` is the standalone API:
frames in, one batched intra encode on ``device``, access units out.
Entropy coding is CABAC (Main profile) or CAVLC (Baseline), both
through the native coders.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.codecs.h264 import syntax
from vlog_tpu_torch.codecs.h264.cabac_enc import (encode_p_slice_cabac,
                                                  encode_slice_cabac)
from vlog_tpu_torch.codecs.h264.cavlc import encode_p_slice, encode_slice
from vlog_tpu_torch.codecs.h264.encoder import (FrameLevels, encode_gop,
                                                pad_to_mb)
from vlog_tpu_torch.device import resolve_device


@dataclass
class EncodedFrame:
    """One access unit, ready for fMP4 sample tables or a TS muxer."""

    avcc: bytes          # 4-byte-length-prefixed NALs (AVCC sample format)
    annexb: bytes        # start-code framed
    is_idr: bool
    psnr_y: float


@dataclass
class H264Encoder:
    """Stateful per-rung encoder. Intra-only frames (``encode_levels``,
    ``encode``) are all I slices; every ``idr_period``-th is an IDR (by
    default every frame)."""

    width: int
    height: int
    fps_num: int = 30
    fps_den: int = 1
    qp: int = 26
    idr_period: int = 1
    # None -> config.ENTROPY_THREADS: the threads that code one call's
    # frames when the caller passes no pool
    entropy_threads: int | None = None
    entropy: str = "cavlc"       # "cavlc" | "cabac"
    # In-loop deblocking: the slice headers signal idc=0 and the device
    # program must run codecs/h264/deblock.py on every reconstruction.
    deblock: bool = False
    # where ``encode`` runs its device DSP (resolved at the call)
    device: str | torch.device = "cuda"
    _frame_index: int = field(default=0, init=False)
    _idr_pic_id: int = field(default=0, init=False)

    def __post_init__(self):
        if self.entropy_threads is None:
            self.entropy_threads = config.ENTROPY_THREADS
        if self.entropy not in ("cavlc", "cabac"):
            raise ValueError(f"unknown entropy coder {self.entropy!r}")
        # CABAC is prohibited in Baseline (spec A.2.1): signal Main so the
        # SPS, avcC and RFC 6381 string match the toolset.
        profile = (syntax.PROFILE_MAIN if self.entropy == "cabac"
                   else syntax.PROFILE_BASELINE)
        self.sps = syntax.make_sps(syntax.SpsConfig(
            width=self.width, height=self.height, fps_num=self.fps_num,
            fps_den=self.fps_den, profile_idc=profile))
        self.pps = syntax.make_pps(init_qp=self.qp,
                                   cabac=self.entropy == "cabac")

    def start_at(self, frame: int, gop_len: int) -> None:
        """Continue the numbering of a stream at display frame ``frame``
        (a resumed run): the frame index that drives intra frames'
        ``idr_pic_id`` and the chain counter that numbers each chain's
        IDR, as an uninterrupted run would have them there."""
        self._frame_index = frame
        self._idr_pic_id = (frame // gop_len) % 65536 if gop_len > 1 else 0

    def _slice_fns(self):
        if self.entropy == "cabac":
            i_fn, p_fn = encode_slice_cabac, encode_p_slice_cabac
        else:
            i_fn, p_fn = encode_slice, encode_p_slice
        return (partial(i_fn, deblock=self.deblock),
                partial(p_fn, deblock=self.deblock))

    @property
    def avcc_config(self) -> bytes:
        return syntax.avcc_config(self.sps, self.pps)

    @property
    def codec_string(self) -> str:
        return syntax.codec_string(self.sps)

    def headers_annexb(self) -> bytes:
        return syntax.annexb([self.sps, self.pps])

    def _map(self, pack, n: int, pool: ThreadPoolExecutor | None) -> list:
        """``pack`` over frames 0..n-1: on ``pool``, else on a per-call
        pool of ``entropy_threads`` (the C coders release the GIL; the
        slices are independent, so the bytes do not depend on it)."""
        if pool is not None:
            return list(pool.map(pack, range(n)))
        if n == 1 or self.entropy_threads <= 1:
            return [pack(i) for i in range(n)]
        with ThreadPoolExecutor(self.entropy_threads,
                                thread_name_prefix="vlog-entropy") as own:
            return list(own.map(pack, range(n)))

    def _pack_one(self, frame_id: int, lv: FrameLevels, frame_qp: int,
                  psnr: float) -> EncodedFrame:
        slice_fn, _ = self._slice_fns()
        idr = (frame_id % self.idr_period) == 0
        # frame_num counts frames since the last IDR; neighbouring IDRs
        # differ in idr_pic_id
        nal = slice_fn(lv, qp=frame_qp, init_qp=self.qp,
                       frame_num=(frame_id % self.idr_period) % 256,
                       idr=idr, idr_pic_id=frame_id % 2)
        raw = nal.to_bytes()
        # avc1 tracks carry parameter sets only in avcC; the Annex-B form
        # repeats them in-band at each IDR
        prefix = [self.sps, self.pps] if idr else []
        return EncodedFrame(avcc=len(raw).to_bytes(4, "big") + raw,
                            annexb=syntax.annexb(prefix + [nal]),
                            is_idr=idr, psnr_y=psnr)

    def encode_chain(self, intra: FrameLevels, p_frames: list[dict],
                     qps: np.ndarray, psnrs: np.ndarray | None = None,
                     pool: ThreadPoolExecutor | None = None
                     ) -> list[EncodedFrame]:
        """Entropy-code one I+P mini-GOP: ``intra`` is frame 0's levels,
        ``p_frames`` the inter level dicts (luma/chroma_dc/chroma_ac/mv)
        of frames 1..clen-1, ``qps`` the QP each frame was coded at. The
        frames' slices are independent: they code on ``pool``'s threads,
        or on ``entropy_threads`` of the call's own, same bytes."""
        slice_fn, p_slice_fn = self._slice_fns()
        idr_pic_id = self._idr_pic_id
        self._idr_pic_id = (self._idr_pic_id + 1) % 65536
        psnr = (lambda i: float(psnrs[i]) if psnrs is not None
                else float("nan"))

        def pack(i: int) -> EncodedFrame:
            if i == 0:
                nal = slice_fn(intra, qp=int(qps[0]), init_qp=self.qp,
                               frame_num=0, idr=True, idr_pic_id=idr_pic_id)
                annexb = syntax.annexb([self.sps, self.pps, nal])
            else:
                nal = p_slice_fn(p_frames[i - 1], qp=int(qps[i]),
                                 init_qp=self.qp, frame_num=i)
                annexb = syntax.annexb([nal])
            raw = nal.to_bytes()
            return EncodedFrame(
                avcc=len(raw).to_bytes(4, "big") + raw, annexb=annexb,
                is_idr=i == 0, psnr_y=psnr(i))

        return self._map(pack, 1 + len(p_frames), pool)

    def encode_levels(self, levels: dict, qps: np.ndarray,
                      psnrs: np.ndarray | None = None,
                      pool: ThreadPoolExecutor | None = None
                      ) -> list[EncodedFrame]:
        """Entropy-code a batch of intra frames already on the host:
        ``levels`` holds numpy ``luma_dc/luma_ac/chroma_dc/chroma_ac``
        with a leading frame axis, ``qps`` the per-frame QP the device
        used; the frames code on ``pool``'s threads or the call's own."""
        n = levels["luma_dc"].shape[0]
        first = self._frame_index
        self._frame_index += n

        def pack(i: int) -> EncodedFrame:
            lv = FrameLevels(levels["luma_dc"][i], levels["luma_ac"][i],
                             levels["chroma_dc"][i], levels["chroma_ac"][i],
                             int(qps[i]))
            psnr = float(psnrs[i]) if psnrs is not None else float("nan")
            return self._pack_one(first + i, lv, int(qps[i]), psnr)

        return self._map(pack, n, pool)

    def encode(self, y: np.ndarray, u: np.ndarray, v: np.ndarray
               ) -> list[EncodedFrame]:
        """Encode a batch of intra frames: y (N, H, W), u/v (N, H/2, W/2)
        uint8 on the host. The planes are padded to whole macroblocks,
        encoded in one batched ``encode_gop`` on ``device`` at ``qp``,
        and their levels entropy-coded on the host. ``psnr_y`` is the
        reconstruction's against the padded source over (height, width),
        in float64 (99.0 where the MSE is below 1e-9)."""
        dev = resolve_device(self.device)
        n = y.shape[0]
        y, u, v = pad_to_mb(y), pad_to_mb(u, 8), pad_to_mb(v, 8)
        out = encode_gop(*(torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                           for p in (y, u, v)), qp=self.qp)
        recon_y = out["recon_y"].cpu().numpy()
        levels = {k: out[k].cpu().numpy() for k in
                  ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")}
        vh, vw = self.height, self.width
        err = (recon_y[:, :vh, :vw].astype(np.int64)
               - y[:, :vh, :vw].astype(np.int64))
        mse = np.mean(err.astype(np.float64) ** 2, axis=(1, 2))
        psnrs = np.where(mse < 1e-9, 99.0,
                         10 * np.log10(255 ** 2 / np.maximum(mse, 1e-12)))
        return self.encode_levels(levels, np.full(n, self.qp), psnrs)
