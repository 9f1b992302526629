"""Per-rung H.264 encoder object: parameter sets, frame numbering and the
entropy coding of device levels (port of ``vlog_tpu/codecs/h264/api.py``).

The device programs (parallel/ladder.py) produce levels and MVs; this
object turns them into AVCC samples (fMP4) and Annex-B access units
(MPEG-TS): one I+P chain at a time (``encode_chain``) or a batch of
intra frames (``encode_levels``). Entropy coding is CABAC (Main profile)
or CAVLC (Baseline), both through the native coders.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import numpy as np

from vlog_tpu_torch.codecs.h264 import syntax
from vlog_tpu_torch.codecs.h264.cabac_enc import (encode_p_slice_cabac,
                                                  encode_slice_cabac)
from vlog_tpu_torch.codecs.h264.cavlc import encode_p_slice, encode_slice
from vlog_tpu_torch.codecs.h264.encoder import FrameLevels


@dataclass
class EncodedFrame:
    """One access unit, ready for fMP4 sample tables or a TS muxer."""

    avcc: bytes          # 4-byte-length-prefixed NALs (AVCC sample format)
    annexb: bytes        # start-code framed
    is_idr: bool
    psnr_y: float


@dataclass
class H264Encoder:
    """Stateful per-rung encoder. Every intra-only frame
    (``encode_levels``) is an IDR."""

    width: int
    height: int
    fps_num: int = 30
    fps_den: int = 1
    qp: int = 26
    entropy: str = "cavlc"       # "cavlc" | "cabac"
    # In-loop deblocking: the slice headers signal idc=0 and the device
    # program must run codecs/h264/deblock.py on every reconstruction.
    deblock: bool = False
    _frame_index: int = field(default=0, init=False)
    _idr_pic_id: int = field(default=0, init=False)

    def __post_init__(self):
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

    def _pack_one(self, frame_id: int, lv: FrameLevels, frame_qp: int,
                  psnr: float) -> EncodedFrame:
        slice_fn, _ = self._slice_fns()
        # an IDR resets frame_num; neighbouring IDRs differ in idr_pic_id
        nal = slice_fn(lv, qp=frame_qp, init_qp=self.qp, frame_num=0,
                       idr=True, idr_pic_id=frame_id % 2)
        raw = nal.to_bytes()
        # avc1 tracks carry parameter sets only in avcC; the Annex-B form
        # repeats them in-band at each IDR
        return EncodedFrame(avcc=len(raw).to_bytes(4, "big") + raw,
                            annexb=syntax.annexb([self.sps, self.pps, nal]),
                            is_idr=True, psnr_y=psnr)

    def encode_chain(self, intra: FrameLevels, p_frames: list[dict],
                     qps: np.ndarray, psnrs: np.ndarray | None = None
                     ) -> list[EncodedFrame]:
        """Entropy-code one I+P mini-GOP: ``intra`` is frame 0's levels,
        ``p_frames`` the inter level dicts (luma/chroma_dc/chroma_ac/mv)
        of frames 1..clen-1, ``qps`` the QP each frame was coded at."""
        slice_fn, p_slice_fn = self._slice_fns()
        idr_pic_id = self._idr_pic_id
        self._idr_pic_id = (self._idr_pic_id + 1) % 65536
        psnr = (lambda i: float(psnrs[i]) if psnrs is not None
                else float("nan"))
        frames = []
        for i in range(1 + len(p_frames)):
            if i == 0:
                nal = slice_fn(intra, qp=int(qps[0]), init_qp=self.qp,
                               frame_num=0, idr=True, idr_pic_id=idr_pic_id)
                annexb = syntax.annexb([self.sps, self.pps, nal])
            else:
                nal = p_slice_fn(p_frames[i - 1], qp=int(qps[i]),
                                 init_qp=self.qp, frame_num=i)
                annexb = syntax.annexb([nal])
            raw = nal.to_bytes()
            frames.append(EncodedFrame(
                avcc=len(raw).to_bytes(4, "big") + raw, annexb=annexb,
                is_idr=i == 0, psnr_y=psnr(i)))
        return frames

    def encode_levels(self, levels: dict, qps: np.ndarray,
                      psnrs: np.ndarray | None = None) -> list[EncodedFrame]:
        """Entropy-code a batch of intra frames already on the host:
        ``levels`` holds numpy ``luma_dc/luma_ac/chroma_dc/chroma_ac``
        with a leading frame axis, ``qps`` the per-frame QP the device
        used."""
        n = levels["luma_dc"].shape[0]
        first = self._frame_index
        self._frame_index += n
        out = []
        for i in range(n):
            lv = FrameLevels(levels["luma_dc"][i], levels["luma_ac"][i],
                             levels["chroma_dc"][i], levels["chroma_ac"][i],
                             int(qps[i]))
            psnr = float(psnrs[i]) if psnrs is not None else float("nan")
            out.append(self._pack_one(first + i, lv, int(qps[i]), psnr))
        return out
