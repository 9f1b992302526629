"""Per-rung H.264 encoder object: parameter sets + CABAC entropy coding
of one I+P chain (port of ``vlog_tpu/codecs/h264/api.py``, CABAC only).

The device program (parallel/ladder.py) produces levels and MVs; this
object turns one chain of them into AVCC samples for the fMP4 writer.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from vlog_tpu_torch.codecs.h264 import syntax
from vlog_tpu_torch.codecs.h264.cabac_enc import (encode_p_slice_cabac,
                                                  encode_slice_cabac)
from vlog_tpu_torch.codecs.h264.encoder import FrameLevels


@dataclass
class EncodedFrame:
    """One access unit, ready for fMP4 sample tables."""

    avcc: bytes          # 4-byte-length-prefixed NALs (AVCC sample format)
    annexb: bytes        # start-code framed
    is_idr: bool
    psnr_y: float


@dataclass
class H264Encoder:
    """Stateful per-rung encoder; Main profile (CABAC)."""

    width: int
    height: int
    fps_num: int = 30
    fps_den: int = 1
    qp: int = 26
    entropy: str = "cabac"
    # In-loop deblocking: the slice headers signal idc=0 and the device
    # program must run codecs/h264/deblock.py on every reconstruction.
    deblock: bool = False
    _idr_pic_id: int = field(default=0, init=False)

    def __post_init__(self):
        if self.entropy != "cabac":
            raise ValueError(f"entropy coder {self.entropy!r} is not ported; "
                             "the port codes CABAC only")
        self.sps = syntax.make_sps(syntax.SpsConfig(
            width=self.width, height=self.height, fps_num=self.fps_num,
            fps_den=self.fps_den, profile_idc=syntax.PROFILE_MAIN))
        self.pps = syntax.make_pps(init_qp=self.qp, cabac=True)

    @property
    def avcc_config(self) -> bytes:
        return syntax.avcc_config(self.sps, self.pps)

    @property
    def codec_string(self) -> str:
        return syntax.codec_string(self.sps)

    def encode_chain(self, intra: FrameLevels, p_frames: list[dict],
                     qps: np.ndarray, psnrs: np.ndarray | None = None
                     ) -> list[EncodedFrame]:
        """Entropy-code one I+P mini-GOP: ``intra`` is frame 0's levels,
        ``p_frames`` the inter level dicts (luma/chroma_dc/chroma_ac/mv)
        of frames 1..clen-1, ``qps`` the QP each frame was coded at."""
        idr_pic_id = self._idr_pic_id
        self._idr_pic_id = (self._idr_pic_id + 1) % 65536
        psnr = (lambda i: float(psnrs[i]) if psnrs is not None
                else float("nan"))
        frames = []
        for i in range(1 + len(p_frames)):
            if i == 0:
                nal = encode_slice_cabac(
                    intra, qp=int(qps[0]), init_qp=self.qp, frame_num=0,
                    idr=True, idr_pic_id=idr_pic_id, deblock=self.deblock)
                annexb = syntax.annexb([self.sps, self.pps, nal])
            else:
                nal = encode_p_slice_cabac(
                    p_frames[i - 1], qp=int(qps[i]), init_qp=self.qp,
                    frame_num=i, deblock=self.deblock)
                annexb = syntax.annexb([nal])
            raw = nal.to_bytes()
            frames.append(EncodedFrame(
                avcc=len(raw).to_bytes(4, "big") + raw, annexb=annexb,
                is_idr=i == 0, psnr_y=psnr(i)))
        return frames
