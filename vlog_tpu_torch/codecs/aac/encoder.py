"""First-party AAC-LC encoder: the MDCT on the device, entropy coding on
the host (port of ``vlog_tpu/codecs/aac/encoder.py``).

Every ladder rung gets an AAC track at the ladder's audio bitrate. The
split mirrors the video path: the filterbank runs as one batched float32
matmul over the whole chunk of frames on the encoder's device
(``mdct.forward_mdct``), scalefactor selection and quantization are
vectorized float64 numpy, and the serial Huffman/bitstream pack stays on
the host (``huffman.py``).

Toolset: long windows only (window_sequence=0, sine shape), per-band
scalefactors via a constant-SNR allocation, closed-loop bit targeting
with the shared RateController. No TNS/PNS/M-S on the encode side.
Nothing catches an error of the device step: a failed MDCT fails the
encode.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from vlog_tpu_torch.codecs.aac import huffman as H
from vlog_tpu_torch.codecs.aac import tables as T
from vlog_tpu_torch.codecs.aac.adts import AacConfig, adts_header
from vlog_tpu_torch.codecs.aac.decoder import SF_OFFSET
from vlog_tpu_torch.codecs.aac.mdct import forward_mdct, mdct_matrix, sine_window
from vlog_tpu_torch.backends.rate_control import RateController
from vlog_tpu_torch.device import resolve_device
from vlog_tpu_torch.media.bitstream import BitWriter

MAX_QUANT = 8191                 # spec cap for escape coding
_ROUND = 0.4054                  # standard AAC quantizer rounding offset


def _frame_blocks(pcm: np.ndarray) -> np.ndarray:
    """(n_samples,) float -> (n_frames, 2048) overlapped 50% blocks.

    Prepends one priming frame of zeros (standard 1024-sample encoder
    delay) and zero-pads the tail.
    """
    n = pcm.shape[-1]
    n_frames = (n + 1024 - 1) // 1024 + 1
    padded = np.zeros((n_frames + 1) * 1024)
    padded[1024:1024 + n] = pcm
    idx = np.arange(2048)[None, :] + 1024 * np.arange(n_frames)[:, None]
    return padded[idx]


def _quantize_frame(spec: np.ndarray, sfs: np.ndarray,
                    swb: list[int], max_sfb: int) -> np.ndarray:
    """Spec coefficients + per-band scalefactors -> quantized levels."""
    q = np.zeros(1024, np.int32)
    for b in range(max_sfb):
        lo, hi = swb[b], swb[b + 1]
        gain = 2.0 ** (0.25 * (sfs[b] - SF_OFFSET))
        x = spec[lo:hi] / gain
        mag = np.floor(np.abs(x) ** 0.75 + _ROUND).astype(np.int64)
        q[lo:hi] = (np.sign(x) * np.minimum(mag, MAX_QUANT)).astype(np.int32)
    return q


@functools.lru_cache(maxsize=8)
def _device_basis(n: int, device: torch.device) -> torch.Tensor:
    """``mdct_matrix(n)`` as float32 on ``device``, built once per device
    (encoders are built per rendition)."""
    return torch.as_tensor(mdct_matrix(n), dtype=torch.float32, device=device)


@dataclass
class AacEncoder:
    """Stateful LC encoder; feed (channels, n) float PCM chunks in order.
    The MDCT runs on ``device`` (default ``"cuda"``; raises without
    CUDA)."""

    sample_rate: int = 48000
    channels: int = 2
    bitrate: int = 128_000
    device: str | torch.device = "cuda"

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        self.config = AacConfig(sample_rate=self.sample_rate,
                                channels=self.channels)
        sr = self.config.sr_index
        self.swb = T.SWB_OFFSET_1024[sr]
        self.num_swb = T.NUM_SWB_1024[sr]
        self.max_sfb = self.num_swb
        frame_rate = self.sample_rate / 1024.0
        # Reuse the video loop: "frames" are AAC frames; bytes per frame
        # tracks the audio bitrate. Wide QP range maps to base scalefactor.
        self._rc = RateController(
            target_bps=self.bitrate, fps=frame_rate, init_qp=148,
            min_qp=80, max_qp=250, max_step=6,
            # the scalefactor rate curve is smooth across ~170 steps;
            # single-step probing (a video-cliff defense) would drag
            # undershoot recovery out 6x
            converged_down_step=6.0)
        self._window = sine_window(2048)
        self._basis = _device_basis(2048, self.device)

    # -- DSP ---------------------------------------------------------------
    def _mdct_all(self, pcm: np.ndarray) -> np.ndarray:
        """(channels, n) -> (channels, n_frames, 1024): the windowed blocks
        go to the device as float32, one batched matmul, float64 back."""
        blocks = np.stack([_frame_blocks(c * 32768.0) for c in pcm])
        windowed = torch.from_numpy((blocks * self._window).astype(np.float32))
        out = forward_mdct(windowed.to(self.device), basis=self._basis)
        return out.cpu().numpy().astype(np.float64)

    # -- per-frame coding --------------------------------------------------
    def _choose_scalefactors(self, spec: np.ndarray, base_sf: int
                             ) -> np.ndarray:
        """Constant-SNR allocation: quantizer step follows band amplitude
        (sqrt-energy), anchored at the rate-controlled base."""
        sfs = np.full(self.max_sfb, base_sf, np.int32)
        amps = np.empty(self.max_sfb)
        for b in range(self.max_sfb):
            lo, hi = self.swb[b], self.swb[b + 1]
            amps[b] = np.sqrt(np.mean(spec[lo:hi] ** 2) + 1e-9)
        ref = np.exp(np.mean(np.log(amps + 1e-9)))
        adj = np.round(2.0 * np.log2((amps + 1e-9) / ref)).astype(np.int32)
        sfs = np.clip(base_sf + adj, 1, 255)
        # Ensure escape-code range: raise sf where |q| would exceed cap.
        for b in range(self.max_sfb):
            lo, hi = self.swb[b], self.swb[b + 1]
            peak = np.max(np.abs(spec[lo:hi])) if hi > lo else 0.0
            while peak > 0:
                gain = 2.0 ** (0.25 * (sfs[b] - SF_OFFSET))
                if (peak / gain) ** 0.75 + _ROUND <= MAX_QUANT:
                    break
                sfs[b] += 4
        # DPCM deltas must fit the sf codebook (+-60): smooth the chain.
        for b in range(1, self.max_sfb):
            sfs[b] = np.clip(sfs[b], sfs[b - 1] - 60, sfs[b - 1] + 60)
        return sfs

    def _code_channel(self, w: BitWriter, spec: np.ndarray,
                      common_window: bool) -> int:
        """individual_channel_stream; returns payload bit count."""
        start_bits = w.bit_length
        sfs = self._choose_scalefactors(spec, self._rc.qp)
        quant = _quantize_frame(spec, sfs, self.swb, self.max_sfb)

        # Per-band codebooks (exact-cost best pick).
        books = []
        for b in range(self.max_sfb):
            lo, hi = self.swb[b], self.swb[b + 1]
            book, _ = H.best_book(list(quant[lo:hi]))
            books.append(book)

        # global_gain anchors the sf DPCM chain at the first coded band.
        coded = [b for b in range(self.max_sfb) if books[b] != H.ZERO_HCB]
        global_gain = int(sfs[coded[0]]) if coded else int(self._rc.qp)
        w.write_bits(global_gain, 8)

        if not common_window:
            self._write_ics_info(w)

        # section_data (5-bit length escapes, long windows)
        b = 0
        while b < self.max_sfb:
            e = b
            while e < self.max_sfb and books[e] == books[b]:
                e += 1
            w.write_bits(books[b], 4)
            length = e - b
            while length >= 31:
                w.write_bits(31, 5)
                length -= 31
            w.write_bits(length, 5)
            b = e

        # scale_factor_data (DPCM from global_gain, coded bands only)
        prev = global_gain
        for b in coded:
            H.write_scalefactor(w, int(sfs[b]) - prev)
            prev = int(sfs[b])

        w.write_bit(0)      # pulse_data_present
        w.write_bit(0)      # tns_data_present
        w.write_bit(0)      # gain_control_data_present

        # spectral_data
        for b in range(self.max_sfb):
            book = books[b]
            if book == H.ZERO_HCB:
                continue
            dim = H.BOOK_INFO[book][0]
            lo, hi = self.swb[b], self.swb[b + 1]
            for i in range(lo, hi, dim):
                H.write_group(w, book, tuple(int(v) for v in quant[i:i + dim]))
        return w.bit_length - start_bits

    def _write_ics_info(self, w: BitWriter) -> None:
        w.write_bit(0)                  # ics_reserved
        w.write_bits(0, 2)              # ONLY_LONG_SEQUENCE
        w.write_bit(0)                  # sine window
        w.write_bits(self.max_sfb, 6)
        w.write_bit(0)                  # predictor_data_present

    def encode_frames(self, pcm: np.ndarray) -> list[bytes]:
        """(channels, n_samples) float [-1,1) -> raw_data_block payloads.

        One batched MDCT for the whole chunk, then per-frame entropy
        coding with closed-loop bit targeting.
        """
        pcm = np.atleast_2d(pcm)
        if pcm.shape[0] != self.channels:
            raise ValueError(
                f"expected {self.channels} channels, got {pcm.shape[0]}")
        spec = self._mdct_all(pcm)          # (ch, frames, 1024)
        payloads = []
        for f in range(spec.shape[1]):
            w = BitWriter()
            if self.channels == 1:
                w.write_bits(0, 3)          # SCE
                w.write_bits(0, 4)
                self._code_channel(w, spec[0, f], common_window=False)
            else:
                w.write_bits(1, 3)          # CPE
                w.write_bits(0, 4)
                w.write_bit(1)              # common_window
                self._write_ics_info(w)
                w.write_bits(0, 2)          # ms_mask_present = 0
                self._code_channel(w, spec[0, f], common_window=True)
                self._code_channel(w, spec[1, f], common_window=True)
            w.write_bits(7, 3)              # END
            w.byte_align()
            payload = w.getvalue()
            self._rc.observe(len(payload), 1)
            payloads.append(payload)
        return payloads

    def encode_adts(self, pcm: np.ndarray) -> bytes:
        """Convenience: PCM -> ADTS stream (for tests / .aac dumps)."""
        out = bytearray()
        for p in self.encode_frames(pcm):
            out += adts_header(self.config, len(p)) + p
        return bytes(out)
