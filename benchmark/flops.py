"""The chip's peaks and the operations and bytes of the work the per-layer
metrics divide by, counted from shapes.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, at its 700 W
limit): the float32 rate outside the tensor cores, which is what the
port's Whisper runs at (TF32 off), and the HBM3 bandwidth.
"""

from __future__ import annotations

import numpy as np

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


# --------------------------------------------------------------------------
# Whisper
# --------------------------------------------------------------------------

def whisper_encoder_flops(cfg: dict) -> float:
    """One 30 s window through the encoder: the two convolutions, then
    per layer the four projections, the attention products over the
    1500 positions and the feed-forward pair (2 operations a MAC)."""
    d, ffn, mels = cfg["d_model"], cfg["encoder_ffn_dim"], cfg["num_mel_bins"]
    t_in, t = 2 * cfg["max_source_positions"], cfg["max_source_positions"]
    conv = 2 * t_in * d * mels * 3 + 2 * t * d * d * 3
    layer = 2 * t * 4 * d * d + 2 * 2 * t * t * d + 2 * 2 * t * d * ffn
    return float(conv + cfg["encoder_layers"] * layer)


def whisper_cross_kv_flops(cfg: dict) -> float:
    """One window's cross-attention keys and values, every decoder
    layer."""
    d, t = cfg["d_model"], cfg["max_source_positions"]
    return float(cfg["decoder_layers"] * 2 * 2 * t * d * d)


def whisper_decoder_step_flops(cfg: dict, pos: int) -> float:
    """One decoder row at position ``pos``: per layer the self-attention
    projections and its products over the ``pos + 1`` positions cached
    so far, the cross-attention's query and output projections and its
    products over the audio positions, the feed-forward pair; then the
    logits over the vocabulary."""
    d, ffn = cfg["d_model"], cfg["decoder_ffn_dim"]
    t = cfg["max_source_positions"]
    layer = (2 * 4 * d * d + 2 * 2 * (pos + 1) * d
             + 2 * 2 * d * d + 2 * 2 * t * d + 2 * 2 * d * ffn)
    return float(cfg["decoder_layers"] * layer + 2 * d * cfg["vocab_size"])


def whisper_tick_flops(cfg: dict, windows: int, beam: int, prompt: int,
                       steps: int) -> float:
    """A tick of ``windows`` real windows (padding rows left out): their
    encoder and cross K/V once each, then ``prompt`` prefill steps and
    ``steps`` generation steps for each of their ``beam`` rows."""
    rows = windows * beam
    dec = sum(whisper_decoder_step_flops(cfg, p)
              for p in range(prompt + steps))
    return windows * (whisper_encoder_flops(cfg)
                      + whisper_cross_kv_flops(cfg)) + rows * dec


# --------------------------------------------------------------------------
# Separable resize (the fused resize kernel)
# --------------------------------------------------------------------------

def resize_call_cost(frames: int, src_hw: tuple[int, int],
                     a_h: np.ndarray, a_w: np.ndarray) -> tuple[float, float]:
    """(bytes, operations) of one uint8 plane call over ``frames``: each
    input byte read once and each output byte written once; two
    operations per nonzero tap of each pass (rows first: every output
    row over every source column, then every output column)."""
    h_src, w_src = src_hw
    h, w = a_h.shape[0], a_w.shape[0]
    nbytes = frames * (h_src * w_src + h * w)
    taps_h = int(np.count_nonzero(a_h))        # summed over output rows
    taps_w = int(np.count_nonzero(a_w))
    ops = frames * 2 * (taps_h * w_src + taps_w * h)
    return float(nbytes), float(ops)


def roofline_seconds(nbytes: float, ops: float) -> float:
    """The least time the chip could take: the larger of the two
    bounds."""
    return max(nbytes / PEAK_HBM_BYTES_PER_S, ops / PEAK_FP32_FLOPS)
