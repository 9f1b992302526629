"""Continuous-batching ASR engine: one shared Whisper serving every job.

A per-process singleton owns the Whisper assets (loaded once through the
memoized ``load_whisper``) and a cross-job
:class:`~vlog_tpu_torch.asr.queue.WindowQueue`; a tick thread packs
windows from many concurrent jobs into fixed-shape bucketed batches and
runs one batched mel -> encode -> decode forward per tick on the
engine's device. Freed batch rows backfill from the queue as jobs' tails
drain: the continuous-batching core of ``vlog_tpu/asr/engine.py``.

Determinism contract (packing invariance): a job's cues are a pure
function of its own windows. Every forward runs at a power-of-two bucket
of rows, zero-padded rows fill the remainder, and the forward has no
cross-row operation, so row i's tokens do not depend on rows j != i.

This port serves one device and no mesh scheduler: the JAX engine's
slot-lease branch and its Prometheus batch metrics are not here.
``stats()`` and ``batch_log`` are.
"""

from __future__ import annotations

import queue as stdqueue
import threading
import time

import numpy as np
import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.asr import mel as melmod
from vlog_tpu_torch.asr.load import WhisperAssets, load_whisper
from vlog_tpu_torch.asr.queue import BatchKey, WindowQueue, WorkItem
from vlog_tpu_torch.asr.vtt import Cue
from vlog_tpu_torch.utils import failpoints


class AsrJobError(RuntimeError):
    """A batch containing this job's windows failed to decode."""


class JobHandle:
    """One transcription job's membership in the engine.

    ``submit`` windows (compute thread), then iterate :meth:`results`
    until every submitted window has come back. Results arrive in batch
    completion order, not index order — callers slot them by index.
    """

    def __init__(self, engine: "AsrEngine", job: str, key: BatchKey):
        self.job = job
        self.key = key
        self._engine = engine
        self._results: stdqueue.Queue = stdqueue.Queue()
        self._cancelled = threading.Event()
        self.submitted = 0
        self.delivered = 0

    def submit(self, index: int, start_s: float,
               samples: np.ndarray) -> None:
        """Enqueue one VAD-live window (blocks under queue backpressure)."""
        failpoints.hit("asr.submit")
        if self._cancelled.is_set():
            raise AsrJobError(f"job {self.job} is cancelled")
        self._engine._queue.put(
            self.key,
            WorkItem(job=self.job, index=index, start_s=start_s,
                     samples=samples),
            cancel=self._cancelled)
        self.submitted += 1

    def results(self):
        """Yield ``(index, cues, queue_wait_s)`` per submitted window.

        Raises :class:`AsrJobError` if a batch carrying this job's
        windows failed (the engine itself survives and keeps serving
        other jobs)."""
        while self.delivered < self.submitted:
            kind, payload = self._results.get()
            if kind == "error":
                raise AsrJobError(str(payload)) from (
                    payload if isinstance(payload, BaseException) else None)
            self.delivered += 1
            yield payload

    def drain_ready(self):
        """Non-blocking: yield results already delivered by the engine —
        the drain path's in-flight-batch flush (windows decoded between
        the preemption notice and the abort still reach the checkpoint)."""
        while self.delivered < self.submitted:
            try:
                kind, payload = self._results.get_nowait()
            except stdqueue.Empty:
                return
            if kind == "error":
                return
            self.delivered += 1
            yield payload

    def close(self) -> None:
        """Unregister from the engine (always call; idempotent)."""
        self._cancelled.set()
        self._engine._queue.cancel_job(self.job)
        self._engine._drop(self.job)

    # engine-side delivery -------------------------------------------------
    def _deliver(self, index: int, cues: list[Cue], wait_s: float) -> None:
        self._results.put(("ok", (index, cues, wait_s)))

    def _fail(self, exc: BaseException) -> None:
        self._results.put(("error", exc))


class AsrEngine:
    """Per-process continuous-batching Whisper server on the assets'
    device (see module doc)."""

    def __init__(self, assets: WhisperAssets, *,
                 batch_windows: int | None = None,
                 tick_s: float | None = None,
                 queue_max: int | None = None,
                 window_s: float | None = None):
        self.assets = assets
        self.device = assets.model.device
        self.batch_windows = batch_windows or config.ASR_BATCH_WINDOWS
        self.tick_s = config.ASR_TICK_S if tick_s is None else tick_s
        self.window_s = window_s or config.WHISPER_CHUNK_S
        self._queue = WindowQueue(queue_max or config.ASR_QUEUE_MAX)
        self._lock = threading.Lock()             # lock-order: 20
        self._jobs: dict[str, JobHandle] = {}   # guarded-by: _lock
        self._started = False                   # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Batch composition log for tests/stats: one entry per tick with
        # rows/occupancy and the job of every packed window.
        self.batch_log: list[dict] = []         # guarded-by: _lock
        self.windows_decoded = 0                # guarded-by: _lock

    # job lifecycle --------------------------------------------------------

    def begin_job(self, job: str, *, language: str,
                  task: str = "transcribe", max_new: int | None = None,
                  beam: int = 1) -> JobHandle:
        """Register a job; windows co-batch only with jobs sharing the
        same (language, task, max_new, beam): ``generate_batch`` builds
        one shared prompt per batch."""
        key = BatchKey(language=language, task=task, max_new=max_new,
                       beam=beam)
        handle = JobHandle(self, job, key)
        with self._lock:
            self._jobs[job] = handle
            if not self._started:
                self._started = True
                self._thread = threading.Thread(
                    target=self._run, name="vlog-asr-engine", daemon=True)
                self._thread.start()
        return handle

    def detect_language(self, samples: np.ndarray) -> str:
        """Language-id on one window (the job's own first live window, so
        co-batched jobs can never pollute the vote)."""
        from vlog_tpu_torch.asr.decode import detect_language

        batch = melmod.pad_or_trim(samples.astype(np.float32))[None, :]
        feats = melmod.log_mel_spectrogram(
            batch, n_mels=self.assets.cfg.num_mel_bins, device=self.device)
        return detect_language(self.assets, feats)

    def stats(self) -> dict:
        from vlog_tpu_torch.asr.decode import kv_pool

        with self._lock:
            batches = len(self.batch_log)
            occ = (sum(b["occupancy"] for b in self.batch_log) / batches
                   if batches else 0.0)
            return {"batches": batches, "windows": self.windows_decoded,
                    "mean_occupancy": occ,
                    "pending": self._queue.pending(),
                    "kv_pool": kv_pool.stats()}

    def close(self) -> None:
        self._stop.set()
        self._queue.close()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=30)

    def _drop(self, job: str) -> None:
        with self._lock:
            self._jobs.pop(job, None)

    # tick loop ------------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self._queue.wait_for_work(timeout=0.2):
                continue
            if self.tick_s > 0:
                # Coalesce: let concurrent jobs land windows before
                # packing, so the first tick is not a batch of one.
                time.sleep(self.tick_s)
            key = self._queue.pick_key()
            if key is None:
                continue
            items = self._queue.take(key, self.batch_windows)
            if items:
                self._tick(key, items)

    def _bucket_rows(self, n: int) -> int:
        """Smallest power-of-two bucket >= n: every batch runs at one of a
        handful of shapes."""
        rows = 1
        while rows < n:
            rows *= 2
        return rows

    def _tick(self, key: BatchKey, items: list[WorkItem]) -> None:
        t0 = time.monotonic()
        try:
            failpoints.hit("asr.batch")
            n = len(items)
            rows = self._bucket_rows(n)
            stack = [melmod.pad_or_trim(it.samples.astype(np.float32))
                     for it in items]
            stack += [np.zeros_like(stack[0])] * (rows - n)
            batch = np.stack(stack)
            feats = melmod.log_mel_spectrogram(
                batch, n_mels=self.assets.cfg.num_mel_bins,
                device=self.device)
            from vlog_tpu_torch.asr.decode import generate_batch, parse_segments

            toks, no_speech = generate_batch(
                self.assets, feats, language=key.language, task=key.task,
                max_new=key.max_new, beam=key.beam)
            toks, no_speech = toks[:n], no_speech[:n]
            st = self.assets.tokens
            tokenizer = self.assets.tokenizer
            elapsed = time.monotonic() - t0
            results = []
            for row, nsp, it in zip(toks, no_speech, items):
                cues: list[Cue] = []
                if st.no_speech is None or nsp <= 0.6:
                    for seg in parse_segments(row, st,
                                              window_s=self.window_s):
                        text = tokenizer.decode(
                            [t for t in seg.token_ids if t < st.sot])
                        cues.append(Cue(it.start_s + seg.start_s,
                                        it.start_s + seg.end_s, text))
                results.append((it, cues, t0 - it.enqueued_at))
        except Exception as exc:  # noqa: BLE001 — the engine must survive
            # one bad batch; the affected jobs' attempts fail through the
            # normal job-failure handling and the tick loop keeps serving.
            self._fail_items(items, exc)
            return
        with self._lock:
            self.windows_decoded += n
            self.batch_log.append({
                "rows": rows, "n": n, "occupancy": n / rows,
                "jobs": [it.job for it in items], "elapsed_s": elapsed,
            })
            handles = {it.job: self._jobs.get(it.job) for it in items}
        for it, cues, wait_s in results:
            h = handles.get(it.job)
            if h is not None and not h._cancelled.is_set():
                h._deliver(it.index, cues, wait_s)

    def _fail_items(self, items: list[WorkItem], exc: BaseException) -> None:
        with self._lock:
            handles = {it.job: self._jobs.get(it.job) for it in items}
        for job in {it.job for it in items}:
            h = handles.get(job)
            if h is not None:
                h._fail(exc)


# Per-process engine singleton -------------------------------------------

_ENGINE: AsrEngine | None = None
_ENGINE_KEY: tuple | None = None
_ENGINE_LOCK = threading.Lock()


def get_engine(model_dir: str, *,
               device: str | torch.device = "cuda") -> AsrEngine:
    """The process's shared engine, (re)built when the checkpoint dir,
    quant mode or device changes."""
    from vlog_tpu_torch.asr.load import resolve_quant
    from vlog_tpu_torch.device import resolve_device

    global _ENGINE, _ENGINE_KEY
    dev = resolve_device(device)
    quant = resolve_quant()
    key = (str(model_dir), quant, str(dev))
    with _ENGINE_LOCK:
        if _ENGINE is not None and _ENGINE_KEY == key:
            return _ENGINE
        old = _ENGINE
        _ENGINE = None
        _ENGINE_KEY = None
    if old is not None:
        old.close()
    assets = load_whisper(model_dir, quant, device=dev)
    engine = AsrEngine(assets)
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = engine
            _ENGINE_KEY = key
        else:            # lost the race; serve the winner
            engine.close()
        return _ENGINE


def peek_engine() -> AsrEngine | None:
    """The process engine if one exists; never builds one."""
    with _ENGINE_LOCK:
        return _ENGINE


def reset_engine() -> None:
    """Tear down the process engine (joins its tick thread)."""
    global _ENGINE, _ENGINE_KEY
    with _ENGINE_LOCK:
        old, _ENGINE, _ENGINE_KEY = _ENGINE, None, None
    if old is not None:
        old.close()
