"""Operation and byte counts, against counts made another way."""

import numpy as np
import pytest

from benchmark import flops
from benchmark.reference.resize import resample_matrix

SMALL = {"d_model": 768, "encoder_layers": 12, "decoder_layers": 12,
         "encoder_attention_heads": 12, "decoder_attention_heads": 12,
         "encoder_ffn_dim": 3072, "decoder_ffn_dim": 3072,
         "vocab_size": 51865, "num_mel_bins": 80,
         "max_source_positions": 1500, "max_target_positions": 448}


def _matmul_flops(shapes):
    return sum(2 * m * k * n for m, k, n in shapes)


def test_encoder_flops_equal_its_products():
    d, t, f = 768, 1500, 3072
    layer = [(t, d, d)] * 4 + [(t, d, t), (t, t, d)] + [(t, d, f), (t, f, d)]
    conv = [(3000, 80 * 3, d), (t, d * 3, d)]
    want = _matmul_flops(conv) + 12 * _matmul_flops(layer)
    assert flops.whisper_encoder_flops(SMALL) == want
    assert 0.33e12 < want < 0.36e12          # ~0.35 TFLOP a window


def test_decoder_step_flops_equal_its_products():
    d, f, v, p = 768, 3072, 51865, 10
    layer = ([(1, d, d)] * 4 + [(1, d, p + 1), (1, p + 1, d)]
             + [(1, d, d)] * 2 + [(1, d, 1500), (1, 1500, d)]
             + [(1, d, f), (1, f, d)])
    want = 12 * _matmul_flops(layer) + _matmul_flops([(1, d, v)])
    assert flops.whisper_decoder_step_flops(SMALL, p) == want


def test_tick_leaves_padding_rows_out():
    one = flops.whisper_tick_flops(SMALL, 1, 5, 3, 20)
    assert flops.whisper_tick_flops(SMALL, 16, 5, 3, 20) == pytest.approx(16 * one)
    assert flops.whisper_tick_flops(SMALL, 2, 5, 3, 0) == pytest.approx(
        2 * (flops.whisper_encoder_flops(SMALL)
             + flops.whisper_cross_kv_flops(SMALL))
        + 10 * sum(flops.whisper_decoder_step_flops(SMALL, q)
                   for q in range(3)))


def test_resize_cost_reads_and_writes_each_byte_once():
    a_h, a_w = resample_matrix(1080, 720), resample_matrix(1920, 1280)
    nbytes, ops = flops.resize_call_cost(24, (1080, 1920), a_h, a_w)
    assert nbytes == 24 * (1080 * 1920 + 720 * 1280)
    # the dense products, counted over nonzero taps only
    dense = 2 * 24 * (np.count_nonzero(a_h) * 1920
                      + 720 * np.count_nonzero(a_w))
    assert ops == dense
    # bytes bound the call on the card
    assert flops.roofline_seconds(nbytes, ops) == nbytes / flops.PEAK_HBM_BYTES_PER_S
