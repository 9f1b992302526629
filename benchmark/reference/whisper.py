"""Plain Whisper, written from the published architecture (Radford et
al., "Robust Speech Recognition via Large-Scale Weak Supervision", and
the HF ``WhisperModel`` layout), importing nothing of the program.

- ``log_mel``: 400-sample Hann frames at hop 160 (reflect padding), the
  power spectrum without its last frame, a slaney mel bank, log10 with
  the per-window max - 8 floor, then (x + 4) / 4.
- ``encode``: two GELU convolutions (the second at stride 2), sinusoid
  positions as weights, pre-norm layers, a final norm.
- ``decoder_logits``: the teacher-forced decoder over a whole token
  sequence (causal self-attention, cross-attention, no cache), logits
  through the tied embedding.
- ``allowed_logprobs``: the generation rules at one step (suppressed
  tokens, the timestamp grammar of HF ``WhisperTimeStampLogitsProcessor``
  with its probability rule), then log-softmax.
- ``follow_beams``: beam search judged step by step. The program's
  kept beams at each step (parent and token of each, and its score) are
  what is judged: the reference runs its own decoder with its own KV
  cache along them, scores every continuation of every kept beam under
  the rules, and reads (a) how far each kept child lies below the
  ``beam``-th best continuation (a beam search that keeps the wrong
  children, or serves a lower-ranked token, reads its gap), (b) how far
  the program's score of each kept child lies from the reference's, and
  (c) whether the served sequence is the final beam of the best
  length-normalised score (finished beams first), as a gap in
  log-probability. Beam search is a recursion over its own choices, so
  following the program's choices and judging each one checks the whole
  search: every step starts from beams that were themselves judged.

Precision: float32 products with TF32 off (``strict()``), what the
configuration states; log-probabilities and scores in float64.
"""

from __future__ import annotations

import re

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT, HOP = 400, 160
WINDOW_SAMPLES = 30 * SAMPLE_RATE
# A rule decided by a float comparison (timestamps' summed probability
# against the best text token) closer than this is judged both ways.
RULE_TOL = 1e-4


def strict() -> None:
    """float32 products as the configuration states: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a @ b


def _conv(x, w, b, stride):
    return F.conv1d(x, w, b, stride=stride, padding=1)


# --------------------------------------------------------------------------
# Log-mel
# --------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = 3.0 * f / 200.0
    return np.where(f >= 1000.0,
                    15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0)
                                               * (m - 15.0)), 200.0 * m / 3.0)


def mel_bank(n_mels: int) -> np.ndarray:
    """(n_freq, n_mels) slaney-normalised triangles over 0-8 kHz."""
    freqs = np.linspace(0.0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2),
                                 n_mels + 2))
    fb = np.zeros((freqs.size, n_mels))
    for i in range(n_mels):
        lo, c, hi = pts[i:i + 3]
        rise = (freqs - lo) / max(c - lo, 1e-10)
        fall = (hi - freqs) / max(hi - c, 1e-10)
        fb[:, i] = np.maximum(0.0, np.minimum(rise, fall)) * 2.0 / (hi - lo)
    return fb.astype(np.float32)


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, 480000) float32 -> (B, n_mels, 3000)."""
    x = F.pad(audio[:, None, :], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    n_frames = 1 + audio.shape[1] // HOP
    win = torch.as_tensor(np.hanning(N_FFT + 1)[:-1].astype(np.float32),
                          device=audio.device)
    frames = x.unfold(-1, N_FFT, HOP)[:, :n_frames] * win
    power = torch.fft.rfft(frames, dim=-1)[:, :-1].abs() ** 2
    mel = mm(power, torch.as_tensor(mel_bank(n_mels), device=audio.device))
    lg = torch.log10(torch.clamp(mel, min=1e-10))
    lg = torch.maximum(lg, lg.amax(dim=(1, 2), keepdim=True) - 8.0)
    return ((lg + 4.0) / 4.0).transpose(1, 2)


def window_audio(samples: np.ndarray, start_s: float) -> np.ndarray:
    """The 30 s window from ``start_s``, zero-padded at the end."""
    a = int(round(start_s * SAMPLE_RATE))
    out = np.zeros(WINDOW_SAMPLES, np.float32)
    seg = samples[a:a + WINDOW_SAMPLES]
    out[:seg.size] = seg
    return out


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------

def _ln(w, p, x):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-5) * w[p + ".weight"] + w[p + ".bias"]


def _lin(w, p, x, bias=True):
    y = mm(x, w[p + ".weight"].T)
    return y + w[p + ".bias"] if bias else y


def _attend(w, p, xq, xkv, heads, causal):
    b, tq, d = xq.shape
    hd = d // heads
    q = _lin(w, p + ".q_proj", xq) * hd ** -0.5
    k = _lin(w, p + ".k_proj", xkv, bias=False)
    v = _lin(w, p + ".v_proj", xkv)
    split = lambda t: t.reshape(b, -1, heads, hd).transpose(1, 2)  # noqa: E731
    s = mm(split(q), split(k).transpose(-1, -2))
    if causal:
        tk = s.shape[-1]
        mask = torch.ones(tq, tk, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, float("-inf"))
    o = mm(torch.softmax(s, -1), split(v))
    return _lin(w, p + ".out_proj", o.transpose(1, 2).reshape(b, tq, d))


def _mlp(w, p, x):
    h = _ln(w, p + ".final_layer_norm", x)
    return x + _lin(w, p + ".fc2", F.gelu(_lin(w, p + ".fc1", h)))


def encode(w: dict, cfg: dict, mel: torch.Tensor) -> torch.Tensor:
    e = "model.encoder"
    x = F.gelu(_conv(mel, w[e + ".conv1.weight"], w[e + ".conv1.bias"], 1))
    x = F.gelu(_conv(x, w[e + ".conv2.weight"], w[e + ".conv2.bias"], 2))
    x = x.transpose(1, 2) + w[e + ".embed_positions.weight"][:x.shape[2]]
    for i in range(cfg["encoder_layers"]):
        p = f"{e}.layers.{i}"
        h = _ln(w, p + ".self_attn_layer_norm", x)
        x = x + _attend(w, p + ".self_attn", h, h,
                        cfg["encoder_attention_heads"], False)
        x = _mlp(w, p, x)
    return _ln(w, e + ".layer_norm", x)


def decoder_logits(w: dict, cfg: dict, tokens: torch.Tensor,
                   enc: torch.Tensor) -> torch.Tensor:
    """(B, L) tokens -> (B, L, V) logits, position i predicting i + 1."""
    d = "model.decoder"
    emb = w[d + ".embed_tokens.weight"]
    x = emb[tokens] + w[d + ".embed_positions.weight"][:tokens.shape[1]]
    heads = cfg["decoder_attention_heads"]
    for i in range(cfg["decoder_layers"]):
        p = f"{d}.layers.{i}"
        h = _ln(w, p + ".self_attn_layer_norm", x)
        x = x + _attend(w, p + ".self_attn", h, h, heads, True)
        h = _ln(w, p + ".encoder_attn_layer_norm", x)
        x = x + _attend(w, p + ".encoder_attn", h, enc, heads, False)
        x = _mlp(w, p, x)
    return mm(_ln(w, d + ".layer_norm", x), emb.T)


# --------------------------------------------------------------------------
# Generation rules
# --------------------------------------------------------------------------

def _rule_logits(logits, step, last, penult, last_ts, tok: dict):
    """Everything but the probability rule; forbidden -> -inf."""
    v = logits.shape[-1]
    ids = torch.arange(v, device=logits.device)
    ts0, eot = tok["timestamp_begin"], tok["eot"]
    is_ts = ids >= ts0
    bad = torch.zeros_like(logits, dtype=torch.bool)
    for t in tok["suppress"]:
        bad[:, t] = True
    if step == 0:
        for t in tok["begin_suppress"]:
            bad[:, t] = True
        # the first token is a timestamp no later than 1.0 s (or EOT)
        bad |= ((~is_ts) | (ids > ts0 + 50))[None] & (ids != eot)[None]
    lw, pw = last >= ts0, penult >= ts0
    bad |= (lw & pw)[:, None] & is_ts[None]
    bad |= (lw & ~pw)[:, None] & (~is_ts & (ids != eot))[None]
    have = last_ts >= ts0
    floor = torch.where(have, torch.where(lw & ~pw, last_ts, last_ts + 1),
                        torch.full_like(last_ts, ts0))
    bad |= is_ts[None] & (ids[None] < floor[:, None])
    return logits.masked_fill(bad, float("-inf")), is_ts


def allowed_logprobs(logits, step, last, penult, last_ts, tok: dict):
    """Log-probabilities after the rules, in float64: (forced, free) —
    with and without the probability rule's forcing of a timestamp —
    and where that rule is within RULE_TOL of deciding the other way."""
    lg, is_ts = _rule_logits(logits.to(torch.float64), step, last, penult,
                             last_ts, tok)
    lp = torch.log_softmax(lg, -1)
    ts_lp = torch.logsumexp(lp.masked_fill(~is_ts[None], float("-inf")), -1)
    txt = lp.masked_fill(is_ts[None], float("-inf")).amax(-1)
    force = ts_lp > txt
    near = (ts_lp - txt).abs() <= RULE_TOL
    forced = torch.log_softmax(lg.masked_fill(
        force[:, None] & ~is_ts[None], float("-inf")), -1)
    free = torch.log_softmax(lg.masked_fill(
        (force & ~near)[:, None] & ~is_ts[None], float("-inf")), -1)
    return forced, free


def generated_lengths(gen: np.ndarray, eot: int) -> np.ndarray:
    """Generated tokens up to and including the first EOT (all when
    none)."""
    hit = gen == eot
    return np.where(hit.any(1), hit.argmax(1) + 1, gen.shape[1])


# --------------------------------------------------------------------------
# Beam search, judged along the program's beams
# --------------------------------------------------------------------------

def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(b, n, d) -> (b, heads, n, d // heads)."""
    b, n, d = t.shape
    return t.reshape(b, n, heads, d // heads).transpose(1, 2)


def cross_kv(w: dict, cfg: dict, enc: torch.Tensor) -> list:
    """Each decoder layer's cross-attention keys and values over the
    encoder's output, (B, heads, frames, head size) each."""
    heads = cfg["decoder_attention_heads"]
    out = []
    for i in range(cfg["decoder_layers"]):
        p = f"model.decoder.layers.{i}.encoder_attn"
        out.append((_heads(_lin(w, p + ".k_proj", enc, bias=False), heads),
                    _heads(_lin(w, p + ".v_proj", enc), heads)))
    return out


def decoder_step(w: dict, cfg: dict, tokens: torch.Tensor, pos: int,
                 cache: list, ckv: list, beam: int):
    """One position for R = B * ``beam`` rows (window-major): (logits
    (R, V), the self-attention cache with this position appended). The
    ``beam`` rows of a window attend its one encoder output."""
    d = "model.decoder"
    heads = cfg["decoder_attention_heads"]
    emb = w[d + ".embed_tokens.weight"]
    x = (emb[tokens] + w[d + ".embed_positions.weight"][pos])[:, None]
    r, _, dm = x.shape
    hd = dm // heads
    new = []
    for i in range(cfg["decoder_layers"]):
        p = f"{d}.layers.{i}"
        a = p + ".self_attn"
        h = _ln(w, p + ".self_attn_layer_norm", x)
        q = _heads(_lin(w, a + ".q_proj", h) * hd ** -0.5, heads)
        k = _heads(_lin(w, a + ".k_proj", h, bias=False), heads)
        v = _heads(_lin(w, a + ".v_proj", h), heads)
        if cache[i] is not None:
            k = torch.cat([cache[i][0], k], 2)
            v = torch.cat([cache[i][1], v], 2)
        new.append((k, v))
        o = mm(torch.softmax(mm(q, k.transpose(-1, -2)), -1), v)
        x = x + _lin(w, a + ".out_proj", o.transpose(1, 2).reshape(r, 1, dm))
        a = p + ".encoder_attn"
        h = _ln(w, p + ".encoder_attn_layer_norm", x)
        q = _heads(_lin(w, a + ".q_proj", h) * hd ** -0.5, heads)
        q = q.reshape(r // beam, beam, heads, hd).transpose(1, 2)
        ck, cv = ckv[i]
        o = mm(torch.softmax(mm(q, ck.transpose(-1, -2)), -1), cv)
        x = x + _lin(w, a + ".out_proj", o.transpose(1, 2).reshape(r, 1, dm))
        x = _mlp(w, p, x)
    return mm(_ln(w, d + ".layer_norm", x), emb.T)[:, 0], new


def follow_beams(w: dict, cfg: dict, mel: torch.Tensor, prompt: list[int],
                 tok: dict, beam: int, top_s: np.ndarray, top_i: np.ndarray,
                 served: np.ndarray):
    """Judge B windows' beam searches.

    ``top_s``, ``top_i``: (B, S, beam) the program's kept continuations
    at each of its S steps, as scores and flat indices over beam x
    vocabulary (parent * V + token); ``served``: (B, max_new) the tokens
    it served. Returns per window (margin, score gap, served is a final
    beam): the margin is the widest of a kept child's distance below the
    ``beam``-th best continuation and the served beam's distance below
    the best final one (length-normalised, times its length), in nats.
    """
    b, steps, k = top_i.shape
    v = cfg["vocab_size"]
    dev = mel.device
    f64 = torch.float64
    ckv = cross_kv(w, cfg, encode(w, cfg, mel))
    r = b * k
    cache = [None] * cfg["decoder_layers"]
    for i, t in enumerate(prompt):
        logits, cache = decoder_step(
            w, cfg, torch.full((r,), t, dtype=torch.int64, device=dev), i,
            cache, ckv, k)
    eot, ts0 = tok["eot"], tok["timestamp_begin"]
    scores = torch.full((b, k), float("-inf"), dtype=f64, device=dev)
    scores[:, 0] = 0.0
    scores = scores.reshape(r)
    last = torch.full((r,), prompt[-1], dtype=torch.int64, device=dev)
    penult = torch.full((r,), prompt[-2], dtype=torch.int64, device=dev)
    last_ts = torch.full((r,), ts0 - 1, dtype=torch.int64, device=dev)
    finished = torch.zeros(r, dtype=torch.bool, device=dev)
    seqs = torch.full((r, steps), eot, dtype=torch.int64, device=dev)
    only_eot = torch.full((v,), float("-inf"), dtype=f64, device=dev)
    only_eot[eot] = 0.0
    row0 = torch.arange(b, device=dev)[:, None] * k
    kept_i = torch.as_tensor(top_i, dtype=torch.int64, device=dev)
    kept_s = torch.as_tensor(top_s, dtype=f64, device=dev)
    margin = torch.zeros(b, dtype=f64, device=dev)
    gap = torch.zeros(b, dtype=f64, device=dev)
    for step in range(steps):
        kept = kept_i[:, step]
        ms, mine = [], []
        for lp in allowed_logprobs(logits, step, last, penult, last_ts, tok):
            lp = torch.where(finished[:, None], only_eot[None], lp)
            tot = (scores[:, None] + lp).reshape(b, k * v)
            kth = torch.topk(tot, k, dim=1).values[:, -1:]
            got = tot.gather(1, kept)
            ms.append((kth - got).nan_to_num(nan=0.0).clamp(min=0.0))
            mine.append(got)
        # a rule within RULE_TOL of deciding the other way: either reading
        m = torch.minimum(*ms)
        got = torch.maximum(*mine)
        margin = torch.maximum(margin, m.amax(1))
        gap = torch.maximum(gap, (kept_s[:, step] - got).abs().nan_to_num(
            nan=float("inf")).amax(1))
        parent = (kept // v + row0).reshape(r)
        token = (kept % v).reshape(r)
        scores = got.reshape(r)
        seqs = seqs[parent]
        seqs[:, step] = token
        penult, last = last[parent], token
        last_ts = torch.where(token >= ts0, token, last_ts[parent])
        finished = finished[parent] | (token == eot)
        if step + 1 < steps:
            cache = [(ck[parent], cv[parent]) for ck, cv in cache]
            logits, cache = decoder_step(w, cfg, token, len(prompt) + step,
                                         cache, ckv, k)
    lens = (seqs != eot).sum(1).to(f64).clamp(min=1.0)
    norm = scores / lens
    norm = torch.where(finished, norm, norm - 1e9).reshape(b, k)
    want = torch.as_tensor(np.asarray(served), dtype=torch.int64, device=dev)
    tail_ok = (want[:, steps:] == eot).all(1)
    match = (seqs.reshape(b, k, steps) == want[:, None, :steps]).all(-1) \
        & tail_ok[:, None]
    pick = torch.where(match, norm, float("-inf")).argmax(1)
    final = (norm.amax(1) - norm.gather(1, pick[:, None])[:, 0]) \
        * lens.reshape(b, k).gather(1, pick[:, None])[:, 0]
    margin = torch.maximum(margin, torch.where(match.any(1), final, 0.0))
    return (margin.cpu().numpy(), gap.cpu().numpy(),
            match.any(1).cpu().numpy())

# --------------------------------------------------------------------------
# Captions from tokens
# --------------------------------------------------------------------------

def segments(tokens, tok: dict, window_s: float = 30.0):
    """(start, end, text token ids) of one window's generated tokens: a
    timestamp opens a cue, the next one after text closes it; text
    before any timestamp starts at 0, an unclosed cue ends with the
    window."""
    ts0 = tok["timestamp_begin"]
    out, start, cur = [], None, []
    for t in tokens:
        t = int(t)
        if t == tok["eot"]:
            break
        if t >= ts0:
            ts = (t - ts0) * 0.02
            if start is None:
                if cur:
                    out.append((0.0, ts, cur))
                    cur = []
                start = ts
            elif cur:
                out.append((start, ts, cur))
                cur, start = [], None
            else:
                start = ts
        else:
            cur.append(t)
    if cur:
        out.append((start if start is not None else 0.0, window_s, cur))
    return out


def stitch(windows: list[list[tuple[float, float, str]]]):
    """Per-window cues in absolute time, in window order -> the track's
    cues: text whitespace-collapsed, empty ones dropped, a cue ending
    within 0.2 s of what was already emitted dropped, a cue starting
    inside it clamped."""
    out, until = [], 0.0
    for cues in windows:
        for s, e, text in sorted(cues, key=lambda c: (c[0], c[1])):
            text = " ".join(text.split())
            if not text or e <= until + 0.2:
                continue
            out.append((max(s, until), e, text))
            until = e
    return out


class TextDecoder:
    """Token ids -> text: vocabulary tokens are byte-level strings (GPT-2
    byte map), special tokens kept literally, timestamps removed."""

    def __init__(self, vocab: dict[str, int], special: dict[int, str]):
        self.tokens = {i: t for t, i in vocab.items()}
        self.special = special
        inv = _byte_map()
        self.byte = {c: b for b, c in inv.items()}

    def decode(self, ids) -> str:
        parts, run = [], []
        for i in ids:
            i = int(i)
            if i in self.special:
                if run:
                    parts.append(self._text(run))
                    run = []
                parts.append(self.special[i])
            else:
                run.append(self.tokens.get(i, ""))
        if run:
            parts.append(self._text(run))
        return re.sub(r"<\|\d+\.\d+\|>", "", "".join(parts))

    def _text(self, run):
        return bytes(self.byte[c] for c in "".join(run)).decode(
            "utf-8", errors="replace")


def _byte_map() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD))
          + list(range(0xAE, 0x100)))
    cs = list(bs)
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))
