"""Batched greedy and beam decoding with Whisper's timestamp grammar.

The generation rules of ``vlog_tpu/asr/decode.py`` in the same operation
order (suppress lists, the timestamp pairing grammar, monotonic
timestamps, the timestamp-vs-text probability rule, no-speech scoring at
the first step), run as eager step loops over a static-shape KV cache.
The JAX scans run every one of ``max_new`` steps; these loops stop once
every row has finished, which changes no token: a finished greedy row
only emits EOT, and a beam step in which every beam had finished sorts
the beams by score, after which each further step is the identity (the
loop runs that sorting step before it stops).

Beam search picks its top K of each window's K*V candidates with a
stable descending sort, so equal scores keep the lower flat index first
as ``lax.top_k`` does (``torch.topk`` promises no order among ties on
CUDA, and ties are real: every non-EOT continuation of a finished beam
scores ``finfo.min``).

Row independence is the engine's contract: no operation here crosses
batch rows, so row i's tokens do not depend on rows j != i.

Stage spans (``obs/trace.py::stage``, recorded only under a profiler
session on the calling thread): ``asr.encode``, ``asr.cross_kv``,
``asr.prefill``; per beam step ``asr.step.rules`` (suppression, the
timestamp rules, log-softmax), ``asr.step.select`` (top-k and the
sequence gathers), ``asr.step.kv_gather``, ``asr.step.decoder``, and
``asr.finish_check`` (the wait on every row having finished); then
``asr.pull``. :func:`take_steps` gives the decoder steps the loops of
this thread ran since it last asked (the engine's tick record).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np
import torch

from vlog_tpu_torch.asr.load import SpecialTokens, WhisperAssets
from vlog_tpu_torch.asr.model import (
    DecoderCache,
    WhisperConfig,
    WhisperModel,
    cross_kv,
    decoder_step,
    encode,
)
from vlog_tpu_torch.obs.trace import stage

TIME_PRECISION = 0.02       # seconds per timestamp token step
MAX_INITIAL_TIMESTAMP_INDEX = 50   # first cue within 1.0 s
# Steps between checks that every row has finished (each check waits for
# the device; finished rows decode on harmlessly in between).
FINISH_CHECK_STEPS = 8


# --------------------------------------------------------------------------
# Paged KV-cache pool
# --------------------------------------------------------------------------

class KVCachePool:
    """Static-shape DecoderCache pages, reused across engine ticks.

    Keyed by exact buffer shape and device. A leased page may hold stale
    K/V from a previous job: ``decoder_step`` masks attention to positions
    <= pos and writes every such position during this generation, so the
    stale tail is never read.
    """

    _MAX_PAGES = 8          # retained pages across all shapes

    def __init__(self) -> None:
        self._lock = threading.Lock()             # lock-order: 24
        self._pages: dict[tuple, list[DecoderCache]] = {}  # guarded-by: _lock
        self.allocs = 0     # fresh page materializations
        self.reuses = 0     # leases served from the pool

    def _key(self, cfg: WhisperConfig, rows: int, max_len: int,
             device: torch.device) -> tuple:
        hd = cfg.d_model // cfg.decoder_attention_heads
        return ((cfg.decoder_layers, rows, cfg.decoder_attention_heads,
                 max_len, hd), str(device))

    def lease(self, cfg: WhisperConfig, rows: int, max_len: int,
              device: torch.device) -> DecoderCache:
        key = self._key(cfg, rows, max_len, device)
        with self._lock:
            free = self._pages.get(key)
            if free:
                self.reuses += 1
                return free.pop()
            self.allocs += 1
        return DecoderCache.create(cfg, rows, max_len, device)

    def release(self, cache: DecoderCache) -> None:
        key = (tuple(cache.k.shape), str(cache.k.device))
        with self._lock:
            if sum(len(v) for v in self._pages.values()) < self._MAX_PAGES:
                self._pages.setdefault(key, []).append(cache)

    def stats(self) -> dict:
        with self._lock:
            return {"allocs": self.allocs, "reuses": self.reuses,
                    "retained": sum(len(v) for v in self._pages.values())}

    def reset(self) -> None:
        with self._lock:
            self._pages.clear()
            self.allocs = 0
            self.reuses = 0


kv_pool = KVCachePool()

# the most step-loop iterations a generation of this thread ran since the
# last take_steps()
_STEPS = threading.local()


def _ran(steps: int) -> None:
    _STEPS.n = max(getattr(_STEPS, "n", 0), steps)


def take_steps() -> int:
    """Step-loop iterations of the longest generation this thread ran
    since the previous call (0 if none), and reset."""
    n = getattr(_STEPS, "n", 0)
    _STEPS.n = 0
    return n


@dataclass
class Segment:
    start_s: float
    end_s: float
    token_ids: list[int]


# --------------------------------------------------------------------------
# Logit rules
# --------------------------------------------------------------------------

def _suppress_vector(vocab: int, ids: tuple[int, ...]) -> np.ndarray:
    m = np.zeros(vocab, np.float32)
    valid = [i for i in ids if 0 <= i < vocab]
    m[valid] = -np.inf if valid else 0.0
    return m


def apply_timestamp_rules(logits: torch.Tensor, last: torch.Tensor,
                          penult: torch.Tensor, last_ts: torch.Tensor,
                          step_idx: int, *, ts_begin: int, eot: int
                          ) -> torch.Tensor:
    """HF WhisperTimeStampLogitsProcessor semantics, batched.

    ``last``/``penult`` are the two previous generated tokens (prompt
    tokens count as non-timestamps); ``last_ts`` is the most recent
    timestamp token emitted (< ts_begin means none yet).
    """
    neg = torch.finfo(logits.dtype).min
    v = logits.shape[-1]
    ids = torch.arange(v, device=logits.device)
    is_ts = ids >= ts_begin

    lw_ts = last >= ts_begin
    pen_ts = penult >= ts_begin
    # pair grammar: ts,ts -> no more timestamps; x,ts -> must pair up
    # (timestamp or EOT only)
    mask_ts = lw_ts & pen_ts
    mask_text = lw_ts & ~pen_ts
    logits = torch.where(mask_ts[:, None] & is_ts[None, :], neg, logits)
    logits = torch.where(
        mask_text[:, None] & (~is_ts & (ids != eot))[None, :], neg, logits)
    # monotonic timestamps: an unpaired trailing timestamp may repeat
    # (closing a cue at its own start); otherwise strictly increase
    have_ts = last_ts >= ts_begin
    cutoff = torch.where(have_ts,
                         torch.where(lw_ts & ~pen_ts, last_ts, last_ts + 1),
                         ts_begin)
    logits = torch.where(
        is_ts[None, :] & (ids[None, :] < cutoff[:, None]), neg, logits)
    # first generated token must be a timestamp, bounded by max-initial
    if step_idx == 0:
        init_bad = (~is_ts) | (ids > ts_begin + MAX_INITIAL_TIMESTAMP_INDEX)
        logits = torch.where((init_bad & (ids != eot))[None, :], neg, logits)
    # probability rule: if mass on timestamps beats the best text token,
    # force a timestamp
    lp = torch.log_softmax(logits, dim=-1)
    ts_lp = torch.logsumexp(torch.where(is_ts[None, :], lp, neg), dim=-1)
    txt_max = torch.amax(torch.where(is_ts[None, :], neg, lp), dim=-1)
    force_ts = ts_lp > txt_max
    logits = torch.where(force_ts[:, None] & ~is_ts[None, :], neg, logits)
    return logits


def top_k_lower_index_first(x: torch.Tensor, k: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top ``k`` along the last axis, descending, equal values in
    ascending index order (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# --------------------------------------------------------------------------
# Generation
# --------------------------------------------------------------------------

def _prefill(model: WhisperModel, prompt: list[int], rows: int,
             cache: DecoderCache, ckv) -> torch.Tensor:
    logits = None
    for i, t in enumerate(prompt):
        tok = torch.full((rows,), t, dtype=torch.int64, device=model.device)
        logits = decoder_step(model, tok, i, cache, ckv)
    return logits


@torch.inference_mode()
def _generate(model: WhisperModel, mel: torch.Tensor, prompt: list[int],
              suppress_vec: torch.Tensor, begin_suppress_vec: torch.Tensor,
              cache: DecoderCache, *, sot: int, eot: int, ts_begin: int,
              no_speech: int, max_new: int, timestamps: bool):
    with stage("asr.encode"):
        enc = encode(model, mel)
    with stage("asr.cross_kv"):
        ckv = cross_kv(model, enc)
    b = mel.shape[0]
    plen = len(prompt)
    dev = mel.device

    with stage("asr.prefill"):
        logits = _prefill(model, prompt, b, cache, ckv)
    # no-speech probability from the first post-prompt distribution
    probs0 = torch.softmax(logits, dim=-1)
    no_speech_prob = (probs0[:, no_speech] if no_speech >= 0
                      else torch.zeros(b, device=dev))

    last = torch.full((b,), prompt[-1], dtype=torch.int64, device=dev)
    penult = torch.full((b,), prompt[-2] if plen >= 2 else sot,
                        dtype=torch.int64, device=dev)
    last_ts = torch.full((b,), ts_begin - 1, dtype=torch.int64, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    toks = torch.full((b, max_new), eot, dtype=torch.int64, device=dev)
    step = -1
    for step in range(max_new):
        lg = logits + suppress_vec
        if step == 0:
            lg = lg + begin_suppress_vec
        if timestamps:
            lg = apply_timestamp_rules(lg, last, penult, last_ts, step,
                                       ts_begin=ts_begin, eot=eot)
        tok = torch.argmax(lg, dim=-1)
        tok = torch.where(finished, eot, tok)
        finished = finished | (tok == eot)
        last_ts = torch.where(tok >= ts_begin, tok, last_ts)
        toks[:, step] = tok
        penult, last = last, tok
        if step + 1 == max_new or (
                (step + 1) % FINISH_CHECK_STEPS == 0 and bool(finished.all())):
            break
        logits = decoder_step(model, tok, plen + step, cache, ckv)
    _ran(step + 1)
    return toks, no_speech_prob, cache


@torch.inference_mode()
def _generate_beam(model: WhisperModel, mel: torch.Tensor, prompt: list[int],
                   suppress_vec: torch.Tensor,
                   begin_suppress_vec: torch.Tensor, cache: DecoderCache, *,
                   sot: int, eot: int, ts_begin: int, no_speech: int,
                   max_new: int, timestamps: bool, beam: int):
    """Batched beam search over B windows x K beams (B*K cache rows).
    Each step scores all K*V continuations per window, keeps the top K
    (lower flat index first among equal scores) and gathers the KV cache
    rows of the winning parents. Finished beams persist with frozen
    scores (only EOT continues, at zero cost). Selection normalizes by
    generated length."""
    with stage("asr.encode"):
        enc = encode(model, mel)
    b = mel.shape[0]
    k = beam
    bk = b * k
    dev = mel.device
    neg = torch.finfo(torch.float32).min

    with stage("asr.cross_kv"):
        ckv = cross_kv(model, enc)
        # beams share the window's audio: tile cross-KV rows K-fold
        ckv = [(ck.repeat_interleave(k, dim=0),
                cv.repeat_interleave(k, dim=0)) for ck, cv in ckv]
    del enc
    plen = len(prompt)
    with stage("asr.prefill"):
        logits = _prefill(model, prompt, bk, cache, ckv)
    probs0 = torch.softmax(logits.reshape(b, k, -1)[:, 0], dim=-1)
    no_speech_prob = (probs0[:, no_speech] if no_speech >= 0
                      else torch.zeros(b, device=dev))

    # beam 0 live at score 0; the rest start at finfo.min so step 0 fans out
    scores = torch.cat([torch.zeros(1, device=dev),
                        torch.full((k - 1,), neg, device=dev)]).repeat(b)
    seqs = torch.full((bk, max_new), eot, dtype=torch.int64, device=dev)
    last = torch.full((bk,), prompt[-1], dtype=torch.int64, device=dev)
    penult = torch.full((bk,), prompt[-2] if plen >= 2 else sot,
                        dtype=torch.int64, device=dev)
    last_ts = torch.full((bk,), ts_begin - 1, dtype=torch.int64, device=dev)
    finished = torch.zeros((bk,), dtype=torch.bool, device=dev)
    row0 = torch.arange(b, device=dev)[:, None] * k
    all_done = False
    step = -1
    for step in range(max_new):
        if step % FINISH_CHECK_STEPS == 0 and step > 0:
            with stage("asr.finish_check"):
                if bool(finished.all()):
                    all_done = True  # this step sorts the beams, then stop
        with stage("asr.step.rules"):
            lg = logits + suppress_vec
            if step == 0:
                lg = lg + begin_suppress_vec
            if timestamps:
                lg = apply_timestamp_rules(lg, last, penult, last_ts, step,
                                           ts_begin=ts_begin, eot=eot)
            lp = torch.log_softmax(lg, dim=-1)                 # (bk, V)
            v = lp.shape[-1]
            ids = torch.arange(v, device=dev)
            # finished beams: only EOT continues, score unchanged
            lp = torch.where(finished[:, None],
                             torch.where(ids[None, :] == eot, 0.0, neg), lp)
        with stage("asr.step.select"):
            total = scores[:, None] + lp                       # (bk, V)
            top_s, top_i = top_k_lower_index_first(total.reshape(b, k * v),
                                                   k)
            parent = top_i // v                                # (b, k)
            token = (top_i % v).reshape(bk)
            gparent = (parent + row0).reshape(bk)
            scores = top_s.reshape(bk)
            seqs = seqs[gparent]
            seqs[:, step] = token
            penult = last[gparent]
            last = token
            last_ts = torch.where(token >= ts_begin, token, last_ts[gparent])
            finished = finished[gparent] | (token == eot)
        if all_done or step + 1 == max_new:
            break
        with stage("asr.step.kv_gather"):
            cache = DecoderCache(k=cache.k[:, gparent], v=cache.v[:, gparent])
        with stage("asr.step.decoder"):
            logits = decoder_step(model, token, plen + step, cache, ckv)
    _ran(step + 1)

    # length-normalized selection per window (generated tokens before EOT)
    lens = (seqs != eot).sum(dim=1).to(torch.float32)
    norm = scores / torch.clamp(lens, min=1.0)
    # prefer finished beams: unfinished get a -1e9 handicap
    norm = torch.where(finished, norm, norm - 1e9)
    best = torch.argmax(norm.reshape(b, k), dim=1)             # (b,)
    return seqs[best + row0[:, 0]], no_speech_prob, cache


def generate_batch(assets: WhisperAssets, mel: torch.Tensor, *,
                   language: str = "en", task: str = "transcribe",
                   max_new: int | None = None, timestamps: bool = True,
                   beam: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Decode a batch of 30 s mel windows (a tensor on the model's
    device) -> (tokens, no_speech_prob) as numpy.

    ``beam=1`` is the greedy loop; ``beam>1`` runs batched beam search
    with length-normalized selection. One shared prompt per call: callers
    may only co-batch windows agreeing on (language, task, max_new, beam),
    the engine's BatchKey."""
    from vlog_tpu_torch.device import strict_fp32

    strict_fp32()
    st = assets.tokens
    cfg = assets.cfg
    model = assets.model
    if max_new is None:
        max_new = cfg.max_target_positions // 2
    prompt = [st.sot]
    if st.language_ids:
        prompt.append(st.language_token(language))
        prompt.append(st.transcribe if task == "transcribe" else st.translate)
    if not timestamps:
        prompt.append(st.no_timestamps)
    max_new = min(max_new, cfg.max_target_positions - len(prompt) - 1)
    vocab = cfg.vocab_size
    dev = model.device
    sup = torch.as_tensor(
        _suppress_vector(vocab, st.suppress + (st.no_timestamps,)), device=dev)
    bsup = torch.as_tensor(_suppress_vector(vocab, st.begin_suppress),
                           device=dev)
    kwargs = dict(
        sot=st.sot, eot=st.eot, ts_begin=st.timestamp_begin,
        no_speech=st.no_speech if st.no_speech is not None else -1,
        max_new=int(max_new), timestamps=timestamps)
    rows = mel.shape[0] * (int(beam) if beam > 1 else 1)
    cache = kv_pool.lease(cfg, rows, len(prompt) + int(max_new), dev)
    mel = torch.as_tensor(mel, device=dev)
    if beam > 1:
        toks, nsp, cache = _generate_beam(model, mel, prompt, sup, bsup,
                                          cache, beam=int(beam), **kwargs)
    else:
        toks, nsp, cache = _generate(model, mel, prompt, sup, bsup, cache,
                                     **kwargs)
    kv_pool.release(cache)
    with stage("asr.pull"):
        return toks.cpu().numpy().astype(np.int32), nsp.cpu().numpy()


@torch.inference_mode()
def detect_language(assets: WhisperAssets, mel: torch.Tensor) -> str:
    """Single decoder step after <|sot|>, masked to language tokens
    (Whisper's language-id procedure); majority vote over windows."""
    from vlog_tpu_torch.device import strict_fp32

    st = assets.tokens
    if not st.language_ids:
        return "en"
    strict_fp32()
    model = assets.model
    mel = torch.as_tensor(mel, device=model.device)
    enc = encode(model, mel)
    ckv = cross_kv(model, enc)
    b = enc.shape[0]
    cache = DecoderCache.create(assets.cfg, b, 1, model.device)
    logits = decoder_step(
        model, torch.full((b,), st.sot, dtype=torch.int64, device=model.device),
        0, cache, ckv)
    lang_ids = np.array(sorted(st.language_ids.values()))
    sub = logits.cpu().numpy()[:, lang_ids]
    winners = lang_ids[sub.argmax(axis=1)]
    vote = np.bincount(winners).argmax()
    inv = {v: k for k, v in st.language_ids.items()}
    return inv[int(vote)]


# --------------------------------------------------------------------------
# Host-side parsing
# --------------------------------------------------------------------------

def parse_segments(tokens: np.ndarray, st: SpecialTokens, *,
                   window_s: float = 30.0) -> list[Segment]:
    """One window's token stream -> timed segments.

    Tolerant of malformed grammars (untrained models): text before the
    first timestamp lands at [0, window]; an unclosed trailing pair ends
    at the window boundary.
    """
    ts0 = st.timestamp_begin
    segs: list[Segment] = []
    cur_start: float | None = None
    cur: list[int] = []
    for t in tokens.tolist():
        if t == st.eot:
            break
        if t >= ts0:
            t_s = (t - ts0) * TIME_PRECISION
            if cur_start is None:
                if cur:        # leading text with no opening timestamp
                    segs.append(Segment(0.0, t_s, cur))
                    cur = []
                cur_start = t_s
            else:
                if cur:
                    segs.append(Segment(cur_start, t_s, cur))
                    cur = []
                    cur_start = None
                else:          # consecutive timestamps: new opening mark
                    cur_start = t_s
        else:
            cur.append(t)
    if cur:
        segs.append(Segment(cur_start if cur_start is not None else 0.0,
                            window_s, cur))
    return segs
