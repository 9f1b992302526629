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

Mesh integration: the ENGINE owns the slot demand, not the jobs. Given a
``scheduler`` (parallel/scheduler.py), it takes one ticket while its
queue has work, acquires the lease (``acquire(cancel=...)``: closing the
engine aborts a blocked wait) and gives it back when the queue drains,
or at a tick boundary when it holds the full mesh and other demand is
pending (the reference's renegotiation). A batch runs on the lease's
devices: its rows (a power-of-two bucket rounded up to the lease's
width) split into one block per device, in row order, each block
decoded by a Whisper replica on its device (``load.replica_on``: one
per distinct device, kept beside the assets) and the tokens
concatenated in row order; row independence makes the tokens the same
at every width. With no scheduler at all, a generic CUDA engine spreads
over every visible card (the reference's ad-hoc mesh). Each batch feeds
the runtime metrics (obs/metrics.py): batches, windows, occupancy, pad
waste, windows per second, queue waits and
``vlog_device_seconds{plane="asr"}`` (the tick's wall on the device's
clock, so nothing on the CPU).

Each tick's :attr:`AsrEngine.batch_log` entry is its record, kept
without ``prometheus_client``: ``t0``/``t1`` (host ``perf_counter``),
``wall_s`` (``obs/trace.py::DeviceClock`` around the tick on its
devices, read after the tokens' pull; None on the CPU), ``steps`` (the
decoder step loop's iterations) and the engine's time before the tick:
``coalesce_s`` (the ``VLOG_ASR_TICK_S`` sleep), ``lease_s`` (the
scheduler lease wait) and ``take_s`` (picking the key and taking the
windows). The tick's steps are stage spans for a profiler session on the
tick thread: ``asr.tick``, ``asr.mel``, the decoder's
(``asr/decode.py``) and ``asr.post`` (segments and cues).
"""

from __future__ import annotations

import queue as stdqueue
import threading
import time

import numpy as np
import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.asr import mel as melmod
from vlog_tpu_torch.asr.load import WhisperAssets, load_whisper, replica_on
from vlog_tpu_torch.asr.queue import BatchKey, WindowQueue, WorkItem
from vlog_tpu_torch.asr.vtt import Cue
from vlog_tpu_torch.obs.metrics import runtime
from vlog_tpu_torch.obs.trace import DeviceClock, attach, stage
from vlog_tpu_torch.parallel.mesh import visible_cuda_devices
from vlog_tpu_torch.utils import failpoints


# no time before a tick that the tick loop did not start (tests call _tick)
_NO_WAIT = {"coalesce_s": 0.0, "lease_s": 0.0, "take_s": 0.0}


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

    def cancel(self) -> None:
        """Drop this job's queued windows and wake any blocked waiter."""
        self._cancelled.set()
        self._engine._queue.cancel_job(self.job)
        self._results.put(("error", f"job {self.job} cancelled"))

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

    def __init__(self, assets: WhisperAssets, *, scheduler=None,
                 batch_windows: int | None = None,
                 tick_s: float | None = None,
                 queue_max: int | None = None,
                 window_s: float | None = None):
        self.assets = assets
        self.device = assets.model.device
        self.scheduler = scheduler
        self.batch_windows = batch_windows or config.ASR_BATCH_WINDOWS
        self.tick_s = config.ASR_TICK_S if tick_s is None else tick_s
        self.window_s = window_s or config.WHISPER_CHUNK_S
        self._queue = WindowQueue(queue_max or config.ASR_QUEUE_MAX)
        self._lock = threading.Lock()             # lock-order: 20
        self._jobs: dict[str, JobHandle] = {}   # guarded-by: _lock
        self._started = False                   # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lease_held = threading.Event()    # observability only
        # Batch composition log for tests/stats: one entry per tick with
        # rows/occupancy, the job of every packed window and the tick's
        # record (module doc).
        self.batch_log: list[dict] = []         # guarded-by: _lock
        # the tick thread's time before its next tick (tick thread only)
        self._before_tick = _NO_WAIT
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

                def serve():
                    # the tick thread serves every job, so it carries no
                    # job's trace: its stage spans go to a profiler only
                    with attach(None):
                        self._run()

                self._thread = threading.Thread(
                    target=serve, name="vlog-asr-engine", daemon=True)
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

    def active(self) -> bool:
        """Is the engine serving (queued work or a lease held)? The
        worker keeps claiming transcription jobs onto a running engine
        even when slot capacity reads zero."""
        return self._lease_held.is_set() or self._queue.pending() > 0

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
        ticket = None
        lease = None

        def _release():
            nonlocal ticket, lease
            if ticket is not None:
                ticket.close()   # releases the lease too
            ticket = None
            lease = None
            self._lease_held.clear()

        try:
            while not self._stop.is_set():
                if not self._queue.wait_for_work(timeout=0.2):
                    if lease is not None or ticket is not None:
                        _release()   # idle: give the slot back
                    continue
                t0 = time.perf_counter()
                if self.tick_s > 0:
                    # Coalesce: let concurrent jobs land windows before
                    # packing, so the first tick is not a batch of one.
                    time.sleep(self.tick_s)
                t1 = time.perf_counter()
                if self.scheduler is not None and lease is None:
                    from vlog_tpu_torch.parallel.scheduler import SlotCancelled

                    ticket = self.scheduler.admit()
                    try:
                        lease = ticket.acquire(cancel=self._stop)
                    except SlotCancelled:
                        _release()
                        continue
                    self._lease_held.set()
                t2 = time.perf_counter()
                key = self._queue.pick_key()
                if key is None:
                    continue
                items = self._queue.take(key, self.batch_windows)
                if items:
                    self._before_tick = {
                        "coalesce_s": t1 - t0, "lease_s": t2 - t1,
                        "take_s": time.perf_counter() - t2}
                    self._tick(key, items, lease)
                # renegotiate at the tick boundary: a full-mesh lease
                # goes back as soon as other demand queues, any lease
                # when the window queue drains
                if lease is not None:
                    if self._queue.pending() == 0:
                        _release()
                    elif (lease.is_full_mesh
                          and self.scheduler.snapshot()["pending"] > 0):
                        _release()
        finally:
            _release()

    def _bucket_rows(self, n: int, width: int) -> int:
        """Smallest power-of-two bucket >= n (every batch runs at one of a
        handful of shapes), rounded up to a multiple of the mesh width so
        rows split evenly."""
        rows = 1
        while rows < n:
            rows *= 2
        if width > 1:
            rows += (-rows) % width
        return rows

    def _batch_devices(self, lease) -> list:
        """The devices a batch's rows split over: the lease's; with no
        scheduler anywhere, every visible card for an engine on CUDA
        when there are several (the reference's ad-hoc full-device
        mesh); else the engine's own device."""
        if lease is not None:
            return [torch.device(d) for d in lease.devices]
        if self.scheduler is None and self.device.type == "cuda":
            cards = visible_cuda_devices()
            if len(cards) > 1:
                return cards
        return [self.device]

    def _tick(self, key: BatchKey, items: list[WorkItem], lease=None) -> None:
        with stage("asr.tick"):
            self._tick_body(key, items, lease)

    def _tick_body(self, key: BatchKey, items: list[WorkItem], lease) -> None:
        before, self._before_tick = self._before_tick, _NO_WAIT
        t0 = time.monotonic()
        t0_pc = time.perf_counter()
        rows = 0
        try:
            failpoints.hit("asr.batch")
            n = len(items)
            devices = self._batch_devices(lease)
            rows = self._bucket_rows(n, len(devices))
            from vlog_tpu_torch.asr.decode import parse_segments, take_steps

            take_steps()
            clock = DeviceClock(devices)
            with stage("asr.mel"):
                stack = [melmod.pad_or_trim(it.samples.astype(np.float32))
                         for it in items]
                stack += [np.zeros_like(stack[0])] * (rows - n)
                # the whole batch's log-mel on the first device, then split
                feats = melmod.log_mel_spectrogram(
                    np.stack(stack), n_mels=self.assets.cfg.num_mel_bins,
                    device=replica_on(self.assets, devices[0]).model.device)
            toks, no_speech = generate_rows(
                self.assets, feats, devices, language=key.language,
                task=key.task, max_new=key.max_new, beam=key.beam)
            # the pull has drained the devices: the wall reads at once
            clock.stop()
            wall_s = clock.wall_s()
            steps = take_steps()
            toks, no_speech = toks[:n], no_speech[:n]
            st = self.assets.tokens
            tokenizer = self.assets.tokenizer
            elapsed = time.monotonic() - t0
            t1_pc = time.perf_counter()
            results = []
            with stage("asr.post"):
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
            self._observe_batch_metrics(items, rows=0, elapsed=0.0,
                                        wall_s=None, failed=True)
            return
        with self._lock:
            self.windows_decoded += n
            self.batch_log.append({
                "rows": rows, "n": n, "occupancy": n / rows,
                "jobs": [it.job for it in items], "elapsed_s": elapsed,
                "t0": t0_pc, "t1": t1_pc, "wall_s": wall_s, "steps": steps,
                **before,
            })
            handles = {it.job: self._jobs.get(it.job) for it in items}
        for it, cues, wait_s in results:
            h = handles.get(it.job)
            if h is not None and not h._cancelled.is_set():
                h._deliver(it.index, cues, wait_s)
        self._observe_batch_metrics(items, rows=rows, elapsed=elapsed,
                                    wall_s=wall_s, failed=False)

    def _fail_items(self, items: list[WorkItem], exc: BaseException) -> None:
        with self._lock:
            handles = {it.job: self._jobs.get(it.job) for it in items}
        for job in {it.job for it in items}:
            h = handles.get(job)
            if h is not None:
                h._fail(exc)


    @staticmethod
    def _observe_batch_metrics(items: list[WorkItem], *, rows: int,
                               elapsed: float, wall_s: float | None,
                               failed: bool) -> None:
        m = runtime()
        m.asr_batches.labels(result="error" if failed else "ok").inc()
        if failed:
            m.asr_windows.labels(result="failed").inc(len(items))
            return
        n = len(items)
        m.asr_windows.labels(result="decoded").inc(n)
        m.asr_batch_occupancy.set(n / rows if rows else 0.0)
        m.asr_pad_waste.set((rows - n) / rows if rows else 0.0)
        if elapsed > 0:
            m.asr_windows_per_second.set(n / elapsed)
        if wall_s is not None:
            # the batched forward (mel -> generate -> pull) on the
            # device's clock
            m.device_seconds.labels("asr", "forward").inc(wall_s)
        now = time.monotonic()
        for it in items:
            m.asr_queue_wait.observe(max(0.0, now - it.enqueued_at))


def generate_rows(assets: WhisperAssets, feats: torch.Tensor, devices, *,
                  language: str, task: str = "transcribe",
                  max_new: int | None = None, beam: int = 1):
    """Decode a batch of log-mel windows (rows divisible by the number of
    ``devices``) -> (tokens, no_speech_prob) as numpy, in row order: the
    rows split into one contiguous block per device (a device may
    repeat), each decoded by the assets' replica there."""
    from vlog_tpu_torch.asr.decode import generate_batch

    width = len(devices)
    if feats.shape[0] % width:
        raise ValueError(f"{feats.shape[0]} rows do not split over "
                         f"{width} devices")
    k = feats.shape[0] // width
    toks, no_speech = [], []
    for i, d in enumerate(devices):
        rep = replica_on(assets, d)
        t, nsp = generate_batch(
            rep, feats[i * k:(i + 1) * k].to(rep.model.device),
            language=language, task=task, max_new=max_new, beam=beam)
        toks.append(t)
        no_speech.append(nsp)
    return np.concatenate(toks), np.concatenate(no_speech)


# Per-process engine singleton -------------------------------------------

_ENGINE: AsrEngine | None = None
_ENGINE_KEY: tuple | None = None
_ENGINE_LOCK = threading.Lock()


def get_engine(model_dir: str, *, device: str | torch.device = "cuda",
               scheduler=None) -> AsrEngine:
    """The process's shared engine, (re)built when the checkpoint dir,
    quant mode, device or scheduler changes."""
    from vlog_tpu_torch.asr.load import resolve_quant
    from vlog_tpu_torch.device import resolve_device
    from vlog_tpu_torch.parallel.compile_cache import ensure_compile_cache

    global _ENGINE, _ENGINE_KEY
    dev = resolve_device(device)
    quant = resolve_quant()
    key = (str(model_dir), quant, str(dev), id(scheduler))
    with _ENGINE_LOCK:
        if _ENGINE is not None and _ENGINE_KEY == key:
            return _ENGINE
        old = _ENGINE
        _ENGINE = None
        _ENGINE_KEY = None
    if old is not None:
        old.close()
    ensure_compile_cache()
    assets = load_whisper(model_dir, quant, device=dev)
    engine = AsrEngine(assets, scheduler=scheduler)
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
