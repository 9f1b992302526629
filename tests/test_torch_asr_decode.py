"""The port's decoding (``vlog_tpu_torch/asr/decode.py``) against the JAX
package's on the CPU: the timestamp rules, greedy (with and without
timestamps) and beam-5 token streams, language detection, segment
parsing, the KV-cache pool, and the top-k tie order.

Both packages load the shared tiny random-weight checkpoint
(``tiny_model_dir``). Token streams must be equal token for token;
logits after the timestamp rules within 1e-5 (they add, mask and
compare the same float32 values in the same order; log-softmax and
logsumexp may differ in the last bits, which no crafted case here sits
on).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from vlog_tpu.asr import decode as jd
from vlog_tpu.asr import mel as jmel
from vlog_tpu.asr.load import load_whisper as jax_load
from vlog_tpu_torch.asr import decode as td
from vlog_tpu_torch.asr import mel as tmel
from vlog_tpu_torch.asr.load import load_whisper as port_load

RULES_ATOL = 1e-5


@pytest.fixture(scope="module")
def both(tiny_model_dir):
    return jax_load(tiny_model_dir), port_load(tiny_model_dir, device="cpu")


def _windows(seed: int, n: int) -> np.ndarray:
    """n 30 s windows: a modulated harmonic tone, noise, a chirp."""
    rng = np.random.default_rng(seed)
    t = np.arange(16000 * 12) / 16000
    out = []
    for i in range(n):
        f = 150.0 + 60.0 * i
        kind = i % 3
        if kind == 0:
            x = 0.3 * np.sin(2 * np.pi * f * t) * (1 + np.sin(2 * np.pi * 3 * t))
        elif kind == 1:
            x = rng.standard_normal(t.size) * 0.1
        else:
            x = 0.2 * np.sin(2 * np.pi * (f + 200 * t) * t)
        out.append(jmel.pad_or_trim(x.astype(np.float32)))
    return np.stack(out)


def _feats(audio):
    return jmel.log_mel_spectrogram(audio), tmel.log_mel_spectrogram(
        audio, device="cpu")


@pytest.mark.parametrize("beam,timestamps", [(1, True), (1, False),
                                             (5, True)])
def test_tokens_equal_jax(both, beam, timestamps):
    ja, ta = both
    fj, ft = _feats(_windows(beam * 10 + timestamps, 3))
    tj, nj = jd.generate_batch(ja, fj, beam=beam, timestamps=timestamps)
    tt, nt = td.generate_batch(ta, ft, beam=beam, timestamps=timestamps)
    assert tt.dtype == np.int32 and tt.shape == np.asarray(tj).shape
    assert np.array_equal(tt, np.asarray(tj))
    assert np.abs(nt - np.asarray(nj)).max() <= 1e-6


def test_tokens_equal_jax_with_suppression(both):
    """Suppress and begin-suppress lists (passed as arrays, so the
    programs compiled above are reused)."""
    import dataclasses

    ja, ta = both
    sup, bsup = (5, 7, 11, 300), (32, 256)
    ja = dataclasses.replace(ja, tokens=dataclasses.replace(
        ja.tokens, suppress=sup, begin_suppress=bsup))
    ta = dataclasses.replace(ta, tokens=dataclasses.replace(
        ta.tokens, suppress=sup, begin_suppress=bsup))
    fj, ft = _feats(_windows(4, 3))
    for beam in (1, 5):
        tj, _ = jd.generate_batch(ja, fj, beam=beam)
        tt, _ = td.generate_batch(ta, ft, beam=beam)
        assert np.array_equal(tt, np.asarray(tj))


def test_timestamp_rules_match_jax_on_crafted_states():
    """Every branch of the rules: ts/ts pairs, a trailing single ts,
    monotonic cutoffs, the first step's initial-timestamp window, the
    probability rule forcing a timestamp, -inf entries from a suppress
    vector."""
    rng = np.random.default_rng(0)
    v, ts0, eot = 120, 60, 50
    b = 6
    logits = rng.normal(0.0, 2.0, (b, v)).astype(np.float32)
    logits[3, ts0:] += 6.0                     # timestamp mass wins
    logits[:, 7] = -np.inf                     # a suppressed id
    last = np.array([70, 70, 5, 5, 80, 61], np.int32)
    penult = np.array([65, 3, 4, 70, 80, 61], np.int32)
    last_ts = np.array([70, 70, ts0 - 1, 70, 80, 61], np.int32)
    for step in (0, 3):
        want = np.asarray(jd.apply_timestamp_rules(
            logits, last, penult, last_ts, np.int32(step),
            ts_begin=ts0, eot=eot))
        got = td.apply_timestamp_rules(
            torch.from_numpy(logits), torch.from_numpy(last).long(),
            torch.from_numpy(penult).long(), torch.from_numpy(last_ts).long(),
            step, ts_begin=ts0, eot=eot).numpy()
        assert np.array_equal(np.isneginf(got), np.isneginf(want))
        fin = np.isfinite(want)
        assert np.array_equal(fin, np.isfinite(got))
        assert np.array_equal(got == np.finfo(np.float32).min,
                              want == np.finfo(np.float32).min)
        assert np.abs(got[fin] - want[fin]).max() <= RULES_ATOL


def test_top_k_keeps_lower_index_first_on_ties():
    import jax

    x = np.array([[0.5, 2.0, -1.0, 2.0, 2.0, -np.inf, 0.5],
                  [np.finfo(np.float32).min] * 5 + [-3.0, -3.0]],
                 np.float32)
    for k in (1, 3, 5):
        want_v, want_i = jax.lax.top_k(x, k)
        got_v, got_i = td.top_k_lower_index_first(torch.from_numpy(x), k)
        assert np.array_equal(got_i.numpy(), np.asarray(want_i))
        assert np.array_equal(got_v.numpy(), np.asarray(want_v))
    # a large row of equal values: still ascending index order
    flat = torch.full((1, 5000), -7.0)
    flat[0, 4321] = 1.0
    _, idx = td.top_k_lower_index_first(flat, 4)
    assert idx.tolist() == [[4321, 0, 1, 2]]


def test_beam_ties_of_finished_beams(both):
    """Every id but EOT and two text tokens suppressed: beams finish
    early, finished beams put every non-EOT continuation at
    score + finfo.min, and the start-up beams tie at finfo.min, so the
    selection leans on the tie order throughout; JAX's tokens all the
    same."""
    import dataclasses

    ja, ta = both
    keep = {ta.tokens.eot, 10, 11}
    sup = tuple(i for i in range(ta.cfg.vocab_size) if i not in keep)
    ja = dataclasses.replace(ja, tokens=dataclasses.replace(
        ja.tokens, suppress=sup))
    ta = dataclasses.replace(ta, tokens=dataclasses.replace(
        ta.tokens, suppress=sup))
    fj, ft = _feats(_windows(6, 2))
    tj, _ = jd.generate_batch(ja, fj, beam=4, timestamps=False, max_new=20)
    tt, _ = td.generate_batch(ta, ft, beam=4, timestamps=False, max_new=20)
    assert np.array_equal(tt, np.asarray(tj))
    assert (tt == ta.tokens.eot).any(axis=1).all()   # the beams finished


def test_detect_language_matches_jax(both):
    ja, ta = both
    audio = _windows(21, 3)
    for rows in (slice(0, 1), slice(0, 3)):
        fj, ft = _feats(audio[rows])
        assert td.detect_language(ta, ft) == jd.detect_language(ja, fj)


def test_parse_segments_matches_jax(both):
    _, ta = both
    st = ta.tokens
    ts = st.timestamp_begin
    rng = np.random.default_rng(2)
    cases = [np.array([ts, 10, 11, ts + 50, ts + 50, 12, ts + 80, st.eot]),
             np.array([10, 11, ts + 30, 12]),             # leading text
             np.array([ts + 5, ts + 9, 10, ts + 12]),     # consecutive ts
             np.array([ts, 10, 11])]                      # unclosed tail
    cases += [rng.integers(0, ts + 200, 30) for _ in range(40)]
    for toks in cases:
        want = jd.parse_segments(toks, st, window_s=30.0)
        got = td.parse_segments(toks, st, window_s=30.0)
        assert [(s.start_s, s.end_s, s.token_ids) for s in got] == \
            [(s.start_s, s.end_s, s.token_ids) for s in want]


def test_reused_kv_pool_page_gives_the_same_tokens(both):
    _, ta = both
    td.kv_pool.reset()
    _, ft = _feats(_windows(31, 2))
    first, _ = td.generate_batch(ta, ft, beam=1)
    # a different window dirties the page, then the first decodes again
    _, other = _feats(_windows(32, 2))
    td.generate_batch(ta, other, beam=1)
    again, _ = td.generate_batch(ta, ft, beam=1)
    stats = td.kv_pool.stats()
    assert stats["reuses"] >= 2 and stats["allocs"] == 1
    assert np.array_equal(first, again)
    td.kv_pool.reset()
