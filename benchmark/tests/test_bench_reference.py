"""Each plain reference against the port at tiny sizes on the CPU."""

import numpy as np
import pytest
import torch

from benchmark.drivers import captions
from benchmark.reference import cmaf, hevc_core
from benchmark.reference import resize as ref_resize
from benchmark.reference import whisper as ref

TINY = {"d_model": 64, "encoder_layers": 1, "decoder_layers": 2,
        "encoder_attention_heads": 2, "decoder_attention_heads": 2,
        "encoder_ffn_dim": 128, "decoder_ffn_dim": 128, "vocab_size": 51865,
        "num_mel_bins": 80, "max_source_positions": 1500,
        "max_target_positions": 448}


@pytest.mark.parametrize("src,dst", [(1080, 720), (1920, 854), (960, 427),
                                     (96, 48), (48, 96)])
def test_resize_matrices_and_products_equal_the_ports(src, dst):
    from vlog_tpu_torch.ops.resize import apply_resize_matrices, resample_matrix

    a = ref_resize.resample_matrix(src, dst)
    np.testing.assert_array_equal(a, resample_matrix(src, dst))
    x = torch.randint(0, 256, (2, src, 40), dtype=torch.uint8)
    aw = ref_resize.resample_matrix(40, 24)
    got = apply_resize_matrices(x, torch.as_tensor(a), torch.as_tensor(aw))
    assert torch.equal(ref_resize.resize_plane(x, a, aw), got)


def _chain(seed, t=3, h=64, w=96):
    from benchmark.content import smooth_frames

    return [p[None] for p in smooth_frames(0, t, h, w, seed, "cpu")]


def test_hevc_reference_replays_the_ports_chain_bit_for_bit():
    from vlog_tpu_torch.codecs.hevc.core import encode_chain_dsp

    y, u, v = _chain(3)
    rc = {"budget": torch.tensor(50.0), "alpha": torch.tensor(1.0)}
    args = (y, u, v, 8, torch.tensor([28], dtype=torch.int32),
            torch.tensor([[30, 30]], dtype=torch.int32), False, True, rc)
    got, want = encode_chain_dsp(*args), hevc_core.encode_chain_dsp(*args)
    flat = lambda o: [a for part in o[:2] for grp in part
                      for a in (grp if isinstance(grp, tuple) else [grp])
                      if a is not None] + [o[2]["qp_eff"]]
    for a, b in zip(flat(got), flat(want)):
        assert torch.equal(a, b)


def test_control_precisions_change_the_reference():
    # The ladder's control: the resize's products in bfloat16 move most
    # pixels.
    g = torch.Generator().manual_seed(5)
    plane = torch.randint(0, 256, (2, 96, 128), generator=g, dtype=torch.uint8)
    a_h, a_w = (ref_resize.resample_matrix(96, 48),
                ref_resize.resample_matrix(128, 64))
    exact = ref_resize.resize_plane(plane, a_h, a_w)
    low = ref_resize.resize_plane(plane, a_h, a_w, dtype=torch.bfloat16)
    assert (exact != low).float().mean() > 0.1


def test_hvcc_codec_string():
    rec = bytes([1, 0x01, 0x60, 0, 0, 0, 0xB0, 0, 0, 0, 0, 0, 93]) + bytes(10)
    assert cmaf.hvcc_codec_string(rec) == "hvc1.1.6.L93.B0"


@pytest.fixture(scope="module")
def tiny_whisper():
    from benchmark import content
    from vlog_tpu_torch.asr.model import WhisperConfig, WhisperModel

    w = content.random_weights(captions.weight_shapes(TINY), 0, "cpu")
    model = WhisperModel(WhisperConfig.from_hf(TINY)).load_params(dict(w))
    return w, model


def test_whisper_reference_follows_the_ports_forward(tiny_whisper):
    from vlog_tpu_torch.asr import mel as pmel
    from vlog_tpu_torch.asr.model import decode_logits, encode

    from benchmark.content import speech_audio

    w, model = tiny_whisper
    audio = np.stack([ref.window_audio(speech_audio(40, 1, 0, "cpu"), s)
                      for s in (0.0, 25.0)])
    mel = ref.log_mel(torch.as_tensor(audio), 80)
    want_mel = pmel.log_mel_spectrogram(audio, device="cpu")
    assert torch.allclose(mel, want_mel, atol=1e-4)
    enc = ref.encode(w, TINY, want_mel)
    assert torch.allclose(enc, encode(model, want_mel), atol=1e-4)
    toks = torch.tensor([[50258, 50259, 50359, 50364, 300, 400, 50380]] * 2)
    assert torch.allclose(ref.decoder_logits(w, TINY, toks, enc),
                          decode_logits(model, toks, enc), atol=1e-4)


def _assets(model):
    from vlog_tpu_torch.asr.load import (ByteLevelDecoder, WhisperAssets,
                                         derive_special_tokens)
    from vlog_tpu_torch.asr.model import WhisperConfig

    import json
    from benchmark.spec import ROOT

    cfg = json.loads((ROOT / "benchmark/configs/whisper-small.json").read_text())
    tok = cfg["tokens"]
    vocab = captions.vocabulary(tok["sot"] - 1)
    special = captions.special_tokens(tok)
    dec = ByteLevelDecoder(vocab, special, unk_token="<|endoftext|>")
    hf = dict(TINY, decoder_start_token_id=tok["sot"], eos_token_id=tok["eot"])
    gen = dict(cfg["generation"], decoder_start_token_id=tok["sot"],
               eos_token_id=tok["eot"])
    assets = WhisperAssets(cfg=WhisperConfig.from_hf(TINY), model=model,
                           tokenizer=dec, tokens=derive_special_tokens(
                               dec, hf, gen), model_name="tiny")
    tokd = dict(tok, suppress=[tok["notimestamps"]],
                begin_suppress=cfg["generation"]["begin_suppress_tokens"])
    return assets, tokd, vocab, special


def _recorded_beam_search(monkeypatch, assets, mel, beam, max_new):
    """The port's beam search with its kept continuations recorded:
    (served tokens, scores (B, S, beam), flat indices (B, S, beam))."""
    from vlog_tpu_torch.asr import decode

    steps = []
    orig = decode.top_k_lower_index_first

    def topk(x, k):
        vals, idx = orig(x, k)
        steps.append((vals.clone(), idx.clone()))
        return vals, idx

    monkeypatch.setattr(decode, "top_k_lower_index_first", topk)
    gen, _ = decode.generate_batch(assets, mel, beam=beam, max_new=max_new)
    return (gen, torch.stack([v for v, _ in steps], 1).numpy(),
            torch.stack([i for _, i in steps], 1).numpy())


def test_reference_follows_the_ports_beam_search(tiny_whisper, monkeypatch):
    from vlog_tpu_torch.asr.decode import parse_segments
    from vlog_tpu_torch.asr.vtt import stitch_windows, Cue
    from vlog_tpu_torch.asr import mel as pmel

    from benchmark.content import speech_audio

    w, model = tiny_whisper
    assets, tok, vocab, special = _assets(model)
    audio = np.stack([ref.window_audio(speech_audio(60, 2, 0, "cpu"), s)
                      for s in (0.0, 25.0)])
    gen, top_s, top_i = _recorded_beam_search(
        monkeypatch, assets, pmel.log_mel_spectrogram(audio, device="cpu"),
        3, 40)
    prompt = [50258, 50259, 50359]
    mel = ref.log_mel(torch.as_tensor(audio), 80)
    margin, gap, ok = ref.follow_beams(w, TINY, mel, prompt, tok, 3, top_s,
                                       top_i, gen)
    assert ok.all() and margin.max() <= 1e-5 and gap.max() <= 1e-4, (
        margin, gap)
    # a token altered where it is served is no final beam
    bad = gen.copy()
    bad[:, 1] = 4000
    assert not ref.follow_beams(w, TINY, mel, prompt, tok, 3, top_s, top_i,
                                bad)[2].any()
    # a kept child swapped for a continuation outside the top 3
    worse = top_i.copy()
    worse[:, 2, 0] = (worse[:, 2, 0] // TINY["vocab_size"]
                      * TINY["vocab_size"] + 4000)
    assert ref.follow_beams(w, TINY, mel, prompt, tok, 3, top_s, worse,
                            gen)[0].min() > 0.1
    # the program's scores read beside the reference's
    off = top_s.copy()
    off[:, 5] += 0.01
    assert ref.follow_beams(w, TINY, mel, prompt, tok, 3, off, top_i,
                            gen)[1].min() >= 0.009
    # cues from the tokens, as the port's engine and stitcher make them
    text = ref.TextDecoder(vocab, special)
    st = assets.tokens
    for row in gen:
        want = [(s.start_s, s.end_s, s.token_ids)
                for s in parse_segments(row, st)]
        assert [(s, e, ids) for s, e, ids in ref.segments(row, tok)] == want
        ids = [t for t in range(200, 900, 7)] + [50257, 50364]
        assert text.decode(ids) == assets.tokenizer.decode(ids)
    cues = [[(0.0, 4.0, " ab  c"), (3.0, 9.0, "d")], [(8.5, 12.0, "e f")]]
    port = stitch_windows([[Cue(*c) for c in win] for win in cues])
    assert ref.stitch(cues) == [(c.start_s, c.end_s, c.text) for c in port]


def test_decoder_step_equals_the_teacher_forced_decoder(tiny_whisper):
    w, _ = tiny_whisper
    x = torch.randn(2, 80, 3000, generator=torch.Generator().manual_seed(1))
    enc = ref.encode(w, TINY, x)
    toks = torch.tensor([[50258, 50259, 50359, 50364, 300, 400, 50380]] * 2)
    toks = toks.repeat_interleave(2, 0)             # two beams a window
    want = ref.decoder_logits(w, TINY, toks, enc.repeat_interleave(2, 0))
    ckv = ref.cross_kv(w, TINY, enc)
    cache = [None] * TINY["decoder_layers"]
    for pos in range(toks.shape[1]):
        got, cache = ref.decoder_step(w, TINY, toks[:, pos], pos, cache, ckv,
                                      2)
        assert torch.allclose(got, want[:, pos], atol=1e-4)
