"""The port's continuous-batching ASR plane (``vlog_tpu_torch/asr/engine.py``
and ``queue.py``) on the CPU with the shared tiny checkpoint.

Copies of the JAX package's queue and engine tests (grouping,
round-robin fairness, backpressure, packing, backfill, failed-batch
survival, memoization, solo-vs-packed byte identity, checkpoint resume),
with the port's one-device buckets (powers of two), plus the JAX
engine's cues against the port engine's for the same jobs: byte-equal
VTT.
"""

from __future__ import annotations

# slowlane-ok(module): the session-scoped tiny checkpoint keeps every
# engine forward here to a sub-second CPU decode (max_new 8, greedy).

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

pytest.importorskip("transformers")

from vlog_tpu_torch.asr import load as tload
from vlog_tpu_torch.asr.engine import (AsrEngine, AsrJobError, get_engine,
                                       peek_engine, reset_engine)
from vlog_tpu_torch.asr.queue import (BatchKey, QueueCancelled, QueueClosed,
                                      WindowQueue, WorkItem)
from vlog_tpu_torch.asr.vtt import format_vtt
from vlog_tpu_torch.utils import failpoints
from vlog_tpu_torch.worker.transcribe import transcribe_audio_engine


@pytest.fixture(autouse=True)
def _clean_plane():
    failpoints.reset()
    reset_engine()
    yield
    failpoints.reset()
    reset_engine()


@pytest.fixture(scope="module")
def assets(tiny_model_dir):
    return tload.load_whisper(tiny_model_dir, device="cpu")


def _tone(duration_s: float, freq: float = 220.0,
          sr: int = 16000) -> np.ndarray:
    t = np.arange(int(duration_s * sr)) / sr
    return (0.25 * np.sin(2 * np.pi * freq * t)).astype(np.float32)


KEY = BatchKey(language="en", task="transcribe", max_new=8, beam=1)


def _item(job: str, index: int = 0, **kw) -> WorkItem:
    return WorkItem(job=job, index=index, start_s=25.0 * index,
                    samples=np.zeros(16000, np.float32), **kw)


# --------------------------------------------------------------------------
# WindowQueue: grouping, fairness, backpressure
# --------------------------------------------------------------------------

def test_queue_round_robin_one_per_job_per_pass():
    q = WindowQueue(max_items=64)
    for i in range(3):
        q.put(KEY, _item("A", i))
    q.put(KEY, _item("B", 0))
    for i in range(2):
        q.put(KEY, _item("C", i))
    taken = q.take(KEY, 8)
    assert [it.job for it in taken] == ["A", "B", "C", "A", "C", "A"]
    assert q.pending() == 0


def test_queue_rotates_serving_order_between_takes():
    q = WindowQueue(max_items=64)
    for i in range(3):
        q.put(KEY, _item("A", i))
    for i in range(3):
        q.put(KEY, _item("B", i))
    assert [it.job for it in q.take(KEY, 3)] == ["A", "B", "A"]
    assert [it.job for it in q.take(KEY, 2)] == ["B", "A"]


def test_queue_groups_by_batch_key_and_picks_oldest():
    q = WindowQueue(max_items=64)
    es = BatchKey(language="es", task="transcribe", max_new=8, beam=1)
    q.put(es, _item("B", 0, enqueued_at=time.monotonic() - 60.0))
    q.put(KEY, _item("A", 0))
    assert q.pick_key() == es
    assert [it.job for it in q.take(es, 8)] == ["B"]
    assert q.take(es, 8) == []
    assert [it.job for it in q.take(KEY, 8)] == ["A"]


def test_queue_backpressure_cancel_timeout_close():
    q = WindowQueue(max_items=2)
    q.put(KEY, _item("A", 0))
    q.put(KEY, _item("A", 1))
    with pytest.raises(QueueCancelled, match="timed out"):
        q.put(KEY, _item("A", 2), timeout=0.05)
    cancel = threading.Event()
    cancel.set()
    with pytest.raises(QueueCancelled, match="cancelled"):
        q.put(KEY, _item("A", 2), cancel=cancel)
    assert q.cancel_job("A") == 2
    assert q.pending() == 0
    q.close()
    with pytest.raises(QueueClosed):
        q.put(KEY, _item("A", 3))


# --------------------------------------------------------------------------
# Engine: packing, backfill, fairness, failure isolation
# --------------------------------------------------------------------------

def _collect(handle) -> dict[int, list]:
    return {idx: cues for idx, cues, _wait in handle.results()}


def test_engine_packs_windows_from_concurrent_jobs(assets):
    engine = AsrEngine(assets, batch_windows=8, tick_s=0.3)
    try:
        ha = engine.begin_job("A", language="en", max_new=8, beam=1)
        hb = engine.begin_job("B", language="en", max_new=8, beam=1)
        for i in range(3):
            ha.submit(i, 25.0 * i, _tone(5.0))
        for i in range(2):
            hb.submit(i, 25.0 * i, _tone(5.0, 330.0))
        got_a, got_b = _collect(ha), _collect(hb)
        ha.close(), hb.close()
    finally:
        engine.close()
    assert sorted(got_a) == [0, 1, 2] and sorted(got_b) == [0, 1]
    assert engine.windows_decoded == 5
    batch = engine.batch_log[0]
    assert batch["n"] == 5 and batch["rows"] == 8
    assert batch["jobs"] == ["A", "B", "A", "B", "A"]
    assert batch["occupancy"] == pytest.approx(5 / 8)
    assert engine.stats()["batches"] == 1


def test_engine_backfills_freed_rows_across_ticks(assets):
    engine = AsrEngine(assets, batch_windows=4, tick_s=0.3)
    try:
        h = engine.begin_job("long", language="en", max_new=8, beam=1)
        for i in range(6):
            h.submit(i, 25.0 * i, _tone(4.0))
        got = _collect(h)
        h.close()
    finally:
        engine.close()
    assert sorted(got) == list(range(6))
    assert [(b["n"], b["rows"]) for b in engine.batch_log] == [(4, 4), (2, 2)]


def test_short_clip_rides_the_next_batch_not_the_tail(assets):
    engine = AsrEngine(assets, batch_windows=4, tick_s=0.3)
    try:
        hl = engine.begin_job("long", language="en", max_new=8, beam=1)
        hs = engine.begin_job("short", language="en", max_new=8, beam=1)
        for i in range(8):
            hl.submit(i, 25.0 * i, _tone(4.0))
        for i in range(2):
            hs.submit(i, 25.0 * i, _tone(4.0, 330.0))
        got_s = _collect(hs)
        hs.close()
        got_l = _collect(hl)
        hl.close()
    finally:
        engine.close()
    assert sorted(got_s) == [0, 1] and len(got_l) == 8
    served_early = [j for b in engine.batch_log[:2] for j in b["jobs"]]
    assert served_early.count("short") == 2
    assert served_early.count("long") >= 2


def test_engine_survives_a_failed_batch(assets):
    failpoints.arm("asr.batch", count=1)
    engine = AsrEngine(assets, batch_windows=8, tick_s=0.05)
    try:
        ha = engine.begin_job("doomed", language="en", max_new=8, beam=1)
        ha.submit(0, 0.0, _tone(4.0))
        with pytest.raises(AsrJobError):
            list(ha.results())
        ha.close()
        hb = engine.begin_job("fine", language="en", max_new=8, beam=1)
        hb.submit(0, 0.0, _tone(4.0))
        assert sorted(_collect(hb)) == [0]
        hb.close()
    finally:
        engine.close()
    assert engine.windows_decoded == 1 and len(engine.batch_log) == 1


def test_submit_failpoint_and_spec(assets):
    with pytest.raises(ValueError):       # a site the port does not have
        failpoints.arm_from_spec("remote.claim=1")
    assert failpoints.arm_from_spec("asr.submit=1") == ["asr.submit"]
    engine = AsrEngine(assets, batch_windows=2, tick_s=0.0)
    try:
        h = engine.begin_job("A", language="en", max_new=8, beam=1)
        with pytest.raises(failpoints.FailpointError):
            h.submit(0, 0.0, _tone(2.0))
        h.submit(0, 0.0, _tone(2.0))           # budget of one spent
        assert sorted(_collect(h)) == [0]
        h.close()
    finally:
        engine.close()


def test_get_engine_memoized_per_model_dir(tiny_model_dir):
    e1 = get_engine(str(tiny_model_dir), device="cpu")  # slowlane-ok: tiny
    assert get_engine(str(tiny_model_dir), device="cpu") is e1  # slowlane-ok: tiny
    assert peek_engine() is e1 and e1.device.type == "cpu"
    reset_engine()
    assert peek_engine() is None


def test_load_whisper_memoized_on_dir_mtime_and_device(tiny_model_dir):
    a1 = tload.load_whisper(tiny_model_dir, device="cpu")
    assert tload.load_whisper(tiny_model_dir, device="cpu") is a1
    tload.invalidate()
    assert tload.load_whisper(tiny_model_dir, device="cpu") is not a1


def test_entry_points_raise_without_cuda(tiny_model_dir):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_engine(str(tiny_model_dir))             # slowlane-ok: raises
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tload.load_whisper(tiny_model_dir)


# --------------------------------------------------------------------------
# Determinism: byte-identical captions solo vs. packed, resume
# --------------------------------------------------------------------------

def _run_jobs(assets, jobs, tick_s: float = 0.3):
    engine = AsrEngine(assets, batch_windows=8, tick_s=tick_s)
    try:
        with ThreadPoolExecutor(max_workers=len(jobs)) as ex:
            futs = {name: ex.submit(
                transcribe_audio_engine, sam, engine, job_key=name,
                language="en", max_new=8, beam=1, window_s=30.0,
                overlap_s=5.0) for name, sam in jobs}
            out = {name: f.result(timeout=300) for name, f in futs.items()}
    finally:
        engine.close()
    return out, engine.batch_log


def test_vtt_byte_identical_solo_vs_packed(assets):
    sam_a = _tone(65.0, 220.0)                  # 3 windows at 25 s stride
    sam_b = _tone(40.0, 330.0)                  # 2 windows
    solo, _ = _run_jobs(assets, [("A", sam_a)])
    packed, log = _run_jobs(assets, [("A", sam_a), ("B", sam_b)])
    assert any(len(set(b["jobs"])) > 1 for b in log)
    assert format_vtt(packed["A"][0]) == format_vtt(solo["A"][0])
    assert solo["A"][2] == packed["A"][2] == 3


def test_engine_cues_equal_jax_engine(assets, tiny_model_dir):
    """The same two jobs through the JAX engine and the port's: equal
    VTT bytes per job."""
    from vlog_tpu.asr import engine as jengine
    from vlog_tpu.asr.load import load_whisper as jax_load
    from vlog_tpu.asr.vtt import format_vtt as jax_format
    from vlog_tpu.worker.transcribe import \
        transcribe_audio_engine as jax_transcribe

    jobs = [("A", _tone(65.0, 220.0)), ("B", _tone(40.0, 330.0))]
    port, _ = _run_jobs(assets, jobs)
    eng = jengine.AsrEngine(jax_load(tiny_model_dir), batch_windows=8,
                            tick_s=0.3)  # slowlane-ok: tiny checkpoint
    try:
        for name, sam in jobs:
            cues, lang, n = jax_transcribe(
                sam, eng, job_key=name, language="en", max_new=8, beam=1,
                window_s=30.0, overlap_s=5.0)
            assert format_vtt(port[name][0]) == jax_format(cues)
            assert (port[name][1], port[name][2]) == (lang, n)
    finally:
        eng.close()


def test_resume_restores_windows_and_decodes_strictly_fewer(assets):
    sam = _tone(90.0)                           # 4 windows
    states: list[tuple[dict, int]] = []
    engine = AsrEngine(assets, batch_windows=1, tick_s=0.0)
    try:
        cues_full, lang, n = transcribe_audio_engine(
            sam, engine, job_key="full", language="en", max_new=8, beam=1,
            window_s=30.0, overlap_s=5.0,
            checkpoint_cb=lambda st, d, t, f:
                states.append((json.loads(json.dumps(st)), d)))
        decoded_full = engine.windows_decoded
    finally:
        engine.close()
    assert n == 4 and decoded_full == 4
    partial = next(st for st, d in states if d == 2)
    engine2 = AsrEngine(assets, batch_windows=1, tick_s=0.0)
    stats: dict = {}
    try:
        cues_res, lang2, n2 = transcribe_audio_engine(
            sam, engine2, job_key="resumed", language=None, max_new=8,
            beam=1, window_s=30.0, overlap_s=5.0, resume=partial,
            stats_out=stats)
        decoded_res = engine2.windows_decoded
    finally:
        engine2.close()
    assert stats["windows_resumed"] == 2
    assert decoded_res == decoded_full - 2
    assert lang2 == lang == "en"
    assert format_vtt(cues_res) == format_vtt(cues_full)


# --------------------------------------------------------------------------
# The mesh scheduler's lease path (the engine owns one ticket)
# --------------------------------------------------------------------------

def _sched(devices=None):
    import torch

    from vlog_tpu_torch.parallel.scheduler import MeshScheduler

    return MeshScheduler(devices=devices or [torch.device("cpu")], slots=1)


def _wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def test_engine_takes_a_lease_while_busy_and_releases_at_idle(assets):
    """Windows queued while a transcode job holds the only slot wait for
    it; the engine then decodes under its own lease, gives the slot back
    once its queue drains, and its cues equal a scheduler-less engine's."""
    from vlog_tpu_torch.obs.metrics import HAVE_PROMETHEUS, runtime

    sched = _sched()
    wins = [(25.0 * i, _tone(4.0, 220.0 + 50 * i)) for i in range(2)]
    transcode = sched.admit()
    lease = transcode.acquire(timeout=5)
    engine = AsrEngine(assets, scheduler=sched, batch_windows=4, tick_s=0.05)
    ok = runtime().asr_batches.labels(result="ok")
    before = ok._value.get() if HAVE_PROMETHEUS else 0.0
    try:
        h = engine.begin_job("leased", language="en", max_new=8, beam=1)
        for i, (t0, w) in enumerate(wins):
            h.submit(i, t0, w)
        assert engine.active()                 # queued work counts
        time.sleep(0.3)
        assert engine.batch_log == []          # blocked on the slot
        assert sched.snapshot()["pending"] == 1
        lease.release()
        transcode.close()
        got = _collect(h)
        h.close()
        assert _wait_until(lambda: not engine.active())
        assert sched.snapshot()["active"] == 0 and sched.capacity() == 1
    finally:
        engine.close()
        transcode.close()
    if HAVE_PROMETHEUS:
        assert ok._value.get() == before + len(engine.batch_log)
    solo = AsrEngine(assets, batch_windows=4, tick_s=0.05)
    try:
        h = solo.begin_job("solo", language="en", max_new=8, beam=1)
        for i, (t0, w) in enumerate(wins):
            h.submit(i, t0, w)
        want = _collect(h)
        h.close()
    finally:
        solo.close()
    assert got == want


def test_engine_close_aborts_a_blocked_acquire(assets):
    sched = _sched()
    transcode = sched.admit()
    transcode.acquire(timeout=5)
    engine = AsrEngine(assets, scheduler=sched, batch_windows=4, tick_s=0.0)
    h = engine.begin_job("stuck", language="en", max_new=8, beam=1)
    h.submit(0, 0.0, _tone(2.0))
    assert _wait_until(lambda: sched.snapshot()["pending"] == 1)
    engine.close()                       # its stop event cancels the wait
    assert not engine._thread.is_alive()
    assert sched.snapshot()["pending"] == 0   # demand withdrawn once
    transcode.close()
    assert sched.capacity() == 1 and not engine._lease_held.is_set()


def test_job_cancel_wakes_its_waiter_and_drops_windows(assets):
    sched = _sched()
    transcode = sched.admit()
    transcode.acquire(timeout=5)         # keeps the engine from decoding
    engine = AsrEngine(assets, scheduler=sched, batch_windows=4, tick_s=0.0)
    try:
        h = engine.begin_job("gone", language="en", max_new=8, beam=1)
        h.submit(0, 0.0, _tone(2.0))
        h.submit(1, 25.0, _tone(2.0))
        errors = []

        def waiter():
            try:
                list(h.results())
            except AsrJobError as exc:
                errors.append(str(exc))

        th = threading.Thread(target=waiter)
        th.start()
        time.sleep(0.1)
        h.cancel()
        th.join(timeout=5)
        assert errors == ["job gone cancelled"]
        assert engine._queue.pending() == 0
        with pytest.raises(AsrJobError, match="cancelled"):
            h.submit(2, 50.0, _tone(2.0))
        h.close()
    finally:
        transcode.close()
        engine.close()
    assert engine.batch_log == []


def test_engine_under_a_wider_lease_fails_the_batch(assets):
    """A lease of two devices: batches sharded over several devices are
    not ported, so the batch fails (the jobs see it) and the engine
    keeps serving; the lease still goes back at idle."""
    sched = _sched(devices=["cpu:a", "cpu:b"])
    engine = AsrEngine(assets, scheduler=sched, batch_windows=4, tick_s=0.0)
    try:
        h = engine.begin_job("wide", language="en", max_new=8, beam=1)
        h.submit(0, 0.0, _tone(2.0))
        with pytest.raises(AsrJobError, match="item 14"):
            list(h.results())
        h.close()
        assert _wait_until(lambda: not engine.active())
        assert sched.capacity() == 1
    finally:
        engine.close()
    assert engine.batch_log == []


def test_get_engine_keys_on_the_scheduler(tiny_model_dir):
    sched = _sched()
    e1 = get_engine(str(tiny_model_dir), device="cpu")  # slowlane-ok: tiny
    e2 = get_engine(str(tiny_model_dir), device="cpu",  # slowlane-ok: tiny
                    scheduler=sched)
    assert e2 is not e1 and e2.scheduler is sched and peek_engine() is e2
