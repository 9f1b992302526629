"""Transcription job: audio -> batched Whisper on one device -> WebVTT.

The port of ``vlog_tpu/worker/transcribe.py``: extract 16 kHz mono PCM,
cut it into overlapping 30 s windows, skip digital silence and windows
the VAD finds no speech in, decode the rest in batches (directly, or
through the process's continuous-batching engine), stitch the windows'
cues by timestamp and write ``captions.vtt``. One device, no mesh: the
JAX package's data-parallel window sharding is not here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.asr import mel as melmod
from vlog_tpu_torch.asr.vtt import Cue, format_vtt, stitch_windows
from vlog_tpu_torch.backends.base import ProgressFn


class TranscriptionUnavailable(RuntimeError):
    """No model weights configured (VLOG_WHISPER_DIR): the job fails with
    an operator-actionable message."""


@dataclass
class TranscribeResult:
    language: str
    model: str
    vtt_path: str
    text: str
    cue_count: int
    windows: int


# RMS below this is digital silence: no model call needed.
SILENCE_RMS = 1e-4


def _cut_windows(samples: np.ndarray, *, window_s: float, overlap_s: float
                 ) -> list[tuple[float, np.ndarray]]:
    """(start_time, window_samples) list covering the track with overlap."""
    sr = melmod.SAMPLE_RATE
    win = int(window_s * sr)
    stride = int((window_s - overlap_s) * sr)
    n = samples.shape[-1]
    out = []
    t = 0
    while t < n:
        out.append((t / sr, samples[t:t + win]))
        if t + win >= n:
            break
        t += stride
    return out


def _live_windows(samples: np.ndarray, windows, window_s: float) -> list[int]:
    """Indices of the windows above the silence gate that overlap speech."""
    from vlog_tpu_torch.asr.vad import speech_spans, window_has_speech

    spans = speech_spans(samples)
    return [i for i, (t0, w) in enumerate(windows)
            if w.size and float(np.sqrt(np.mean(w ** 2))) > SILENCE_RMS
            and window_has_speech(spans, t0, t0 + window_s)]


def transcribe_audio(
    samples: np.ndarray,
    assets,
    *,
    language: str | None = None,
    window_s: float | None = None,
    overlap_s: float | None = None,
    batch_windows: int = 8,
    max_new: int | None = None,
    progress_cb: ProgressFn | None = None,
) -> tuple[list[Cue], str]:
    """16 kHz mono float PCM -> stitched cues + language code, decoded in
    batches of ``batch_windows`` on the assets' device (no engine)."""
    from vlog_tpu_torch.asr.decode import (detect_language, generate_batch,
                                           parse_segments)

    window_s = window_s or config.WHISPER_CHUNK_S
    overlap_s = overlap_s if overlap_s is not None else config.WHISPER_OVERLAP_S
    windows = _cut_windows(samples, window_s=window_s, overlap_s=overlap_s)
    live = _live_windows(samples, windows, window_s)
    per_window_cues: list[list[Cue]] = [[] for _ in windows]
    tokenizer = assets.tokenizer
    st = assets.tokens
    device = assets.model.device

    done = 0
    for b0 in range(0, len(live), batch_windows):
        idxs = live[b0:b0 + batch_windows]
        batch = np.stack([melmod.pad_or_trim(windows[i][1].astype(np.float32))
                          for i in idxs])
        feats = melmod.log_mel_spectrogram(
            batch, n_mels=assets.cfg.num_mel_bins, device=device)
        if language is None:
            # Detect from the first live window only: one window's encoder
            # pass, never polluted by other windows.
            language = detect_language(assets, feats[:1])
        toks, no_speech = generate_batch(assets, feats, language=language,
                                         max_new=max_new,
                                         beam=config.WHISPER_BEAM)
        for row, nsp, i in zip(toks, no_speech, idxs):
            if st.no_speech is not None and nsp > 0.6:
                continue
            t0 = windows[i][0]
            for seg in parse_segments(row, st, window_s=window_s):
                text = tokenizer.decode([t for t in seg.token_ids
                                         if t < st.sot])
                per_window_cues[i].append(
                    Cue(t0 + seg.start_s, t0 + seg.end_s, text))
        done += len(idxs)
        if progress_cb:
            progress_cb(done, len(live),
                        f"transcribed {done}/{len(live)} windows")
    return stitch_windows(per_window_cues), language or "en"


def transcribe_audio_engine(
    samples: np.ndarray,
    engine,
    *,
    job_key: str,
    language: str | None = None,
    window_s: float | None = None,
    overlap_s: float | None = None,
    max_new: int | None = None,
    beam: int | None = None,
    progress_cb: ProgressFn | None = None,
    checkpoint_cb=None,
    resume: dict | None = None,
    stats_out: dict | None = None,
) -> tuple[list[Cue], str, int]:
    """Engine-backed transcription of one track: VAD-gate the windows
    here (job side), submit the live ones to the shared continuous-
    batching engine, and collect cue results as batches complete.

    ``checkpoint_cb(state, done, total, final)`` fires after every
    completed window with the cumulative resume state (``final=True`` is
    the flush after an abort). ``resume`` is a prior attempt's state: its
    windows are restored verbatim and never re-submitted, so a resumed
    attempt decodes strictly fewer windows and still produces a
    byte-identical VTT (cue floats survive the JSON round-trip exactly).

    Returns (stitched cues, language, total window count).
    """
    window_s = window_s or config.WHISPER_CHUNK_S
    overlap_s = overlap_s if overlap_s is not None else config.WHISPER_OVERLAP_S
    windows = _cut_windows(samples, window_s=window_s, overlap_s=overlap_s)
    live = _live_windows(samples, windows, window_s)
    per_window_cues: list[list[Cue]] = [[] for _ in windows]

    ckpt_windows: dict[str, list[list]] = {}
    resumed: set[int] = set()
    if resume and resume.get("v") == 1:
        language = language or resume.get("language") or None
        for idx_s, rows in (resume.get("windows") or {}).items():
            idx = int(idx_s)
            if 0 <= idx < len(windows):
                per_window_cues[idx] = [Cue(s, e, t) for s, e, t in rows]
                ckpt_windows[idx_s] = [list(r) for r in rows]
                resumed.add(idx)
    to_submit = [i for i in live if i not in resumed]

    if language is None:
        # The job's OWN first live window: co-batched jobs can never
        # pollute the language vote.
        language = (engine.detect_language(windows[live[0]][1])
                    if live else "en")

    handle = engine.begin_job(
        job_key, language=language, max_new=max_new,
        beam=config.WHISPER_BEAM if beam is None else beam)
    done = 0
    total = len(to_submit)
    waits: list[float] = []
    if stats_out is not None:
        stats_out.update({"windows_total": len(windows),
                          "windows_live": len(live),
                          "windows_resumed": len(resumed),
                          "windows_submitted": total})

    def _record(index: int, cues: list[Cue]) -> None:
        per_window_cues[index] = list(cues)
        ckpt_windows[str(index)] = [[c.start_s, c.end_s, c.text]
                                    for c in cues]

    def _state() -> dict:
        return {"v": 1, "language": language, "windows": dict(ckpt_windows)}

    def _wait_stats() -> None:
        if stats_out is not None and waits:
            stats_out["queue_wait_mean_s"] = round(
                sum(waits) / len(waits), 4)
            stats_out["queue_wait_max_s"] = round(max(waits), 4)

    try:
        for i in to_submit:
            handle.submit(i, windows[i][0], windows[i][1])
        for index, cues, wait_s in handle.results():
            _record(index, cues)
            waits.append(wait_s)
            done += 1
            if checkpoint_cb:
                checkpoint_cb(_state(), done, total, False)
            if progress_cb:
                progress_cb(done, total,
                            f"transcribed {done}/{total} windows")
    except BaseException:
        # Drain flush: keep whatever the engine already decoded for this
        # job, then write one final checkpoint so the successor attempt
        # re-submits only what is truly missing.
        for index, cues, _wait_s in handle.drain_ready():
            _record(index, cues)
            done += 1
        if checkpoint_cb:
            try:
                checkpoint_cb(_state(), done, total, True)
            except Exception:  # noqa: BLE001 — the original abort wins
                pass
        _wait_stats()
        raise
    finally:
        handle.close()
    _wait_stats()
    return stitch_windows(per_window_cues), language, len(windows)


def transcribe_video(
    source_path: str | Path,
    out_dir: str | Path,
    *,
    model_dir: str | None = None,
    language: str | None = None,
    progress_cb: ProgressFn | None = None,
    max_new: int | None = None,
    engine=None,
    job_key: str | None = None,
    checkpoint_cb=None,
    resume: dict | None = None,
    stats_out: dict | None = None,
    device: str | torch.device = "cuda",
) -> TranscribeResult:
    """Full transcription job for one video: its audio track through the
    process's continuous-batching engine on ``device`` (weights load
    once; windows from concurrent jobs pack into one batch), then
    ``captions.vtt`` in ``out_dir``."""
    from vlog_tpu_torch.device import resolve_device
    from vlog_tpu_torch.media.audio import extract_audio, resample, to_mono

    dev = resolve_device(device)
    model_dir = model_dir or config.WHISPER_DIR or os.environ.get(
        "VLOG_WHISPER_DIR")
    if not model_dir or not Path(model_dir).exists():
        raise TranscriptionUnavailable(
            "no Whisper weights: set VLOG_WHISPER_DIR or pass model_dir "
            "to a local HF-format model directory")
    if engine is None:
        from vlog_tpu_torch.asr.engine import get_engine

        engine = get_engine(model_dir, device=dev)

    audio = extract_audio(source_path)
    if audio is None or not audio.pcm.size:
        raise ValueError(f"{source_path}: no audio track to transcribe")
    audio = resample(to_mono(audio), melmod.SAMPLE_RATE)
    samples = np.ascontiguousarray(audio.pcm[0], np.float32)

    cues, lang, n_windows = transcribe_audio_engine(
        samples, engine, job_key=job_key or str(out_dir),
        language=language, max_new=max_new, progress_cb=progress_cb,
        checkpoint_cb=checkpoint_cb, resume=resume, stats_out=stats_out)

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    vtt_path = out_dir / "captions.vtt"
    tmp = vtt_path.with_suffix(".vtt.tmp")
    tmp.write_text(format_vtt(cues))
    tmp.rename(vtt_path)
    return TranscribeResult(
        language=lang, model=engine.assets.model_name,
        vtt_path=str(vtt_path), text=" ".join(c.text for c in cues),
        cue_count=len(cues), windows=n_windows)
