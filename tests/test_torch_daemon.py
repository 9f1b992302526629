"""The port's worker daemon (``vlog_tpu_torch.worker.daemon``) on the CPU.

The JAX package's daemon scenarios (``tests/test_daemon.py``, and the
daemon cases of ``test_failure_plane.py``, ``test_preemption.py``,
``test_self_healing.py`` and ``test_commands.py``) re-run against the
port's daemon with a CPU ``TorchBackend`` and ``device="cpu"``, over the
port's own job plane and schema. Then the port-only paths: a cooperative
cancel of a real multi-dispatch run leaves no executor thread; a
``device.fault`` attempt quarantines the lease's device, is refunded and
the probe loop reinstates the device; a failing probe with every device
quarantined takes the restart path (ROADMAP Queue C item 15); a lease
wider than one device raises (ROADMAP Queue A item 14).

The reference daemon against the port's on the same sources (the trees
and rows) is in ``tests/test_torch_daemon_parity.py``.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time

import pytest

from tests.fixtures.media import make_y4m
from tests.test_torch_backend import one_torch_thread  # noqa: F401
from vlog_tpu_torch import config
from vlog_tpu_torch.backends.torch_backend import TorchBackend
from vlog_tpu_torch.db import Database, create_all
from vlog_tpu_torch.db.core import now as db_now
from vlog_tpu_torch.enums import AcceleratorKind, FailureClass, JobKind
from vlog_tpu_torch.jobs import claims, commands as cmds, state as js
from vlog_tpu_torch.jobs import videos as vids
from vlog_tpu_torch.parallel.scheduler import MeshScheduler
from vlog_tpu_torch.utils import failpoints
from vlog_tpu_torch.worker.breaker import BreakerState, CircuitBreaker
from vlog_tpu_torch.worker.brownout import CoordinationBreaker
from vlog_tpu_torch.worker.daemon import JobCancelled, WorkerDaemon
from vlog_tpu_torch.worker.drain import DRAIN_CANCEL_REASON, DrainState


@pytest.fixture(autouse=True)
def _clean_failpoints():
    failpoints.reset()
    yield
    failpoints.reset()


@pytest.fixture
def tdb(run, tmp_path):
    """The port's Database with the port's schema."""
    database = Database(f"sqlite:///{tmp_path / 'port.db'}")
    run(database.connect())
    run(create_all(database))
    yield database
    run(database.disconnect())


@pytest.fixture
def video_job(run, tdb, tmp_path):
    """A pending video row + enqueued transcode job over a tiny Y4M."""
    src = make_y4m(tmp_path / "src.y4m", n_frames=10, width=128, height=96,
                   fps=24)
    video = run(vids.create_video(tdb, "Daemon Test", source_path=str(src),
                                  size_bytes=src.stat().st_size))
    job_id = run(claims.enqueue_job(tdb, video["id"]))
    return video, job_id, src


def make_daemon(db, tmp_path, **kw):
    kw.setdefault("name", "test-worker")
    kw.setdefault("accelerator", AcceleratorKind.TPU)
    kw.setdefault("video_dir", tmp_path / "videos")
    kw.setdefault("progress_min_interval_s", 0.0)
    kw.setdefault("device", "cpu")
    kw.setdefault("backend", TorchBackend(device="cpu"))
    return WorkerDaemon(db, **kw)


async def make_video(db, slug="vid"):
    t = db_now()
    return await db.execute(
        "INSERT INTO videos (slug, title, created_at, updated_at)"
        " VALUES (:s, :s, :t, :t)", {"s": slug, "t": t})


def executor_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("vlog-pipe", "vlog-decode"))]


async def run_until(daemon, db, done, timeout=60.0):
    """Drive ``daemon.run()`` until ``done(rows)`` holds for the jobs
    table, then stop it."""
    task = asyncio.create_task(daemon.run())
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline and not task.done():
            rows = await db.fetch_all("SELECT * FROM jobs ORDER BY id")
            if done(rows):
                break
            await asyncio.sleep(0.02)
    finally:
        daemon.request_stop()
        await asyncio.wait_for(task, 30.0)
    return await db.fetch_all("SELECT * FROM jobs ORDER BY id")


def all_terminal(rows):
    return rows and all(r["completed_at"] is not None
                        or r["failed_at"] is not None for r in rows)


# --------------------------------------------------------------------------
# tests/test_daemon.py's scenarios
# --------------------------------------------------------------------------

def test_daemon_transcodes_video_to_ready(run, tdb, tmp_path, video_job):
    video, job_id, _ = video_job
    daemon = make_daemon(tdb, tmp_path)
    assert run(daemon.poll_once()) is True
    row = run(vids.get_video(tdb, video["id"]))
    assert row["status"] == "ready"
    assert row["duration_s"] > 0
    assert row["thumbnail_path"] and row["width"] == 128
    job = run(tdb.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id}))
    assert job["completed_at"] is not None
    assert job["progress"] == 100.0
    quals = run(tdb.fetch_all(
        "SELECT * FROM video_qualities WHERE video_id=:v", {"v": video["id"]}))
    assert len(quals) >= 1
    qp = run(claims.get_quality_progress(tdb, job_id))
    assert qp and all(r["status"] == "completed" for r in qp.values())
    sprite = run(tdb.fetch_one(
        "SELECT * FROM jobs WHERE video_id=:v AND kind='sprite'",
        {"v": video["id"]}))
    assert sprite is not None
    # a Y4M has no audio: no transcription job
    assert run(tdb.fetch_one(
        "SELECT * FROM jobs WHERE kind='transcription'")) is None
    out = tmp_path / "videos" / video["slug"]
    assert (out / "master.m3u8").exists() and (out / "manifest.mpd").exists()
    spans = run(tdb.fetch_all(
        "SELECT name, attributes FROM job_spans WHERE job_id=:j",
        {"j": job_id}))
    names = {s["name"] for s in spans}
    assert {"job", "worker.attempt", "worker.transcode"} <= names
    assert any(n.startswith("stage.") for n in names)


def test_daemon_processes_sprite_job(run, tdb, tmp_path, video_job):
    video, job_id, _ = video_job
    daemon = make_daemon(tdb, tmp_path)

    async def go():
        await daemon.poll_once()          # transcode
        assert await daemon.poll_once()   # sprite job enqueued by finalize

    run(go())
    sprite = run(tdb.fetch_one(
        "SELECT * FROM jobs WHERE video_id=:v AND kind='sprite'",
        {"v": video["id"]}))
    assert sprite["completed_at"] is not None
    out = tmp_path / "videos" / video["slug"] / "sprites"
    assert (out / "sprites.vtt").exists()
    assert (out / "sprite_01.jpg").exists()


def test_lease_extends_during_transcode(run, tdb, tmp_path, video_job,
                                        monkeypatch):
    video, job_id, _ = video_job
    observed = []
    orig = claims.update_progress

    async def spy(db_, jid, worker, **kw):
        row = await orig(db_, jid, worker, **kw)
        observed.append(row["claim_expires_at"])
        return row

    monkeypatch.setattr(claims, "update_progress", spy)
    initial_expiry = {}
    orig_claim = claims.claim_jobs

    async def claim_spy(*a, **kw):
        rows = await orig_claim(*a, **kw)
        for row in rows:
            initial_expiry[row["id"]] = row["claim_expires_at"]
        return rows

    monkeypatch.setattr(claims, "claim_jobs", claim_spy)
    run(make_daemon(tdb, tmp_path).poll_once())
    assert observed, "no progress writes happened during the transcode"
    assert max(observed) > initial_expiry[job_id]


def test_shutdown_releases_claim_with_attempt_refund(run, tdb, tmp_path,
                                                     video_job):
    video, job_id, _ = video_job
    daemon = make_daemon(tdb, tmp_path)

    async def fake_transcode(job, vid):
        daemon.request_stop()
        raise JobCancelled("shutdown")

    daemon._run_transcode = fake_transcode
    run(daemon.poll_once())
    job = run(tdb.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id}))
    assert job["claimed_by"] is None
    assert job["attempt"] == 0
    assert job["failed_at"] is None
    assert daemon.stats.released == 1


def test_cancel_without_shutdown_counts_as_failure(run, tdb, tmp_path,
                                                   video_job):
    video, job_id, _ = video_job
    daemon = make_daemon(tdb, tmp_path)

    async def fake_transcode(job, vid):
        raise JobCancelled("transcode timed out after 1s")

    daemon._run_transcode = fake_transcode
    run(daemon.poll_once())
    job = run(tdb.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id}))
    assert job["claimed_by"] is None
    assert job["attempt"] == 1
    assert "timed out" in job["error"]


def test_timeout_cancels_cooperatively(run, tdb, tmp_path):
    daemon = make_daemon(tdb, tmp_path)

    def stubborn():
        while not daemon._cancel.is_set():
            time.sleep(0.01)
        raise JobCancelled(daemon._cancel_reason)

    async def go():
        with pytest.raises(JobCancelled, match="timed out"):
            await daemon._run_with_timeout(stubborn, 0.2, "transcode")

    run(go())


def test_startup_recovers_own_stale_claims(run, tdb, tmp_path, video_job):
    video, job_id, _ = video_job

    async def go():
        row = await claims.claim_job(tdb, "test-worker")
        assert row["id"] == job_id
        await make_daemon(tdb, tmp_path).startup()

    run(go())
    job = run(tdb.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id}))
    assert job["claimed_by"] is None
    assert job["attempt"] == 1          # no refund on crash recovery


def test_daemon_run_loop_stops_on_request(run, tdb, tmp_path):
    daemon = make_daemon(tdb, tmp_path, poll_interval_s=0.05,
                         heartbeat_interval_s=0.05)

    async def go():
        task = asyncio.create_task(daemon.run())
        await asyncio.sleep(0.2)
        daemon.request_stop()
        await asyncio.wait_for(task, 5.0)

    run(go())
    w = run(tdb.fetch_one("SELECT * FROM workers WHERE name='test-worker'"))
    assert w["status"] == "offline"
    assert w["last_heartbeat_at"] is not None
    caps = json.loads(w["capabilities"])
    assert caps["backend"] == "torch" and caps["device_kind"] == "cpu"
    assert w["accelerator"] == "tpu"


def test_failed_source_marks_video_failed_after_retries(run, tdb, tmp_path):
    video = run(vids.create_video(tdb, "Ghost", source_path=str(
        tmp_path / "missing.y4m")))
    run(claims.enqueue_job(tdb, video["id"], max_attempts=1))
    run(make_daemon(tdb, tmp_path).poll_once())
    job = run(tdb.fetch_one(
        "SELECT * FROM jobs WHERE video_id=:v", {"v": video["id"]}))
    assert job["failed_at"] is not None
    assert run(vids.get_video(tdb, video["id"]))["status"] == "failed"


def test_daemon_concurrent_slot_claims(run, tdb, tmp_path):
    """Two queued jobs are claimed in one fill round and run concurrently
    on two one-device slot leases (string devices, as in
    tests/test_torch_scheduler.py; the runs follow each lease's device)."""
    vids_rows, job_ids = [], []
    for i in range(2):
        src = make_y4m(tmp_path / f"src{i}.y4m", n_frames=8, width=128,
                       height=96, fps=24)
        video = run(vids.create_video(tdb, f"Slot Job {i}",
                                      source_path=str(src)))
        job_ids.append(run(claims.enqueue_job(tdb, video["id"])))
        vids_rows.append(video)
    sched = MeshScheduler(devices=["cpu:0", "cpu:1"], slots=2)
    daemon = make_daemon(tdb, tmp_path, scheduler=sched)

    async def go():
        assert await daemon._poll_fill() is True
        assert len(daemon._tasks) == 2
        await asyncio.gather(*daemon._tasks)

    run(go())
    assert daemon.stats.claimed == 2 and daemon.stats.completed == 2
    assert sched.capacity() == 2
    slots = []
    for video, job_id in zip(vids_rows, job_ids):
        assert run(vids.get_video(tdb, video["id"]))["status"] == "ready"
        span = run(tdb.fetch_one(
            "SELECT * FROM job_spans WHERE job_id=:j AND name=:n",
            {"j": job_id, "n": "worker.transcode"}))
        attrs = json.loads(span["attributes"] or "{}")
        assert attrs.get("mesh.width") == 1, attrs
        assert attrs.get("mesh.shape") == "1x1", attrs
        assert "mesh.wait_s" in attrs
        slots.append(attrs["mesh.slot"])
    assert sorted(slots) == [0, 1]


def test_daemon_single_job_under_scheduler_gets_full_mesh(run, tdb, tmp_path,
                                                          video_job):
    """One card is one slot: a lone job leases all of it (slot 0, one
    device wide) and the run follows the lease's device."""
    video, job_id, _ = video_job
    sched = MeshScheduler(devices=["cpu:0"], slots=1)
    daemon = make_daemon(tdb, tmp_path, scheduler=sched)

    async def go():
        assert await daemon._poll_fill() is True
        await asyncio.gather(*daemon._tasks)

    run(go())
    assert run(vids.get_video(tdb, video["id"]))["status"] == "ready"
    span = run(tdb.fetch_one(
        "SELECT * FROM job_spans WHERE job_id=:j AND name=:n",
        {"j": job_id, "n": "worker.transcode"}))
    attrs = json.loads(span["attributes"] or "{}")
    assert attrs.get("mesh.slot") == 0 and attrs.get("mesh.width") == 1
    assert attrs.get("mesh.shape") == "1x1"
    assert sched.capacity() == 1


def test_wide_lease_raises_not_implemented(run, tdb, tmp_path, video_job):
    """No fallback: a lone job under a two-device scheduler leases both
    devices, and the port refuses a dispatch over several devices
    (ROADMAP Queue A item 14) instead of quietly using one."""
    video, job_id, _ = video_job
    sched = MeshScheduler(devices=["cpu:0", "cpu:1"], slots=2)
    daemon = make_daemon(tdb, tmp_path, scheduler=sched)

    async def go():
        assert await daemon._poll_fill() is True
        await asyncio.gather(*daemon._tasks)

    run(go())
    job = run(tdb.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id}))
    assert job["completed_at"] is None
    assert "NotImplementedError" in job["error"] and "item 14" in job["error"]
    assert sched.capacity() == 2


def test_daemon_refuses_cuda_without_cuda(tdb, tmp_path):
    """No fallback: the default device is "cuda", and without CUDA the
    daemon raises at construction instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WorkerDaemon(tdb, name="w", video_dir=tmp_path)


# --------------------------------------------------------------------------
# The port's compute under the daemon: cancel, device faults, restart
# --------------------------------------------------------------------------

def test_timeout_cancel_of_a_real_run_leaves_no_thread(run, tdb, tmp_path,
                                                       video_job,
                                                       monkeypatch):
    """A timeout cancel lands between dispatches of a real two-dispatch
    run: the attempt fails as transient, no executor thread is left, the
    next attempt completes."""
    video, job_id, _ = video_job
    monkeypatch.setattr(config, "RETRY_BACKOFF_BASE_S", 0.0)
    monkeypatch.setattr(config, "SEGMENT_DURATION_S", 0.25)
    monkeypatch.setattr(config, "TPU_FRAME_BATCH", 6)
    real = config.transcode_timeout_s
    calls = []

    def first_times_out(duration_s, rung):
        calls.append(rung)
        return 0.0 if len(calls) == 1 else real(duration_s, rung)

    monkeypatch.setattr(config, "transcode_timeout_s", first_times_out)
    daemon = make_daemon(tdb, tmp_path)
    progress = []
    orig_cb = daemon._make_progress_cb

    def spy_cb(*a):
        cb = orig_cb(*a)

        def wrapped(done, total, msg):
            progress.append(done)
            return cb(done, total, msg)
        return wrapped

    daemon._make_progress_cb = spy_cb
    import gc

    from vlog_tpu_torch.parallel.executor import StagedBatch

    # with the cyclic collector off, a staged batch (its device outputs)
    # that a reference cycle through the cancel's traceback kept alive
    # would still be here after the attempt
    gc.collect()
    gc.disable()
    try:
        assert run(daemon.poll_once()) is True
        left = [o for o in gc.get_objects() if isinstance(o, StagedBatch)]
    finally:
        gc.enable()
    assert left == []
    job = run(tdb.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id}))
    assert job["completed_at"] is None and job["attempt"] == 1
    assert "timed out" in job["error"]
    assert progress == [6], "the cancel must land after the first dispatch"
    assert executor_threads() == []
    hist = run(claims.get_failure_history(tdb, job_id))
    assert [h["failure_class"] for h in hist] == ["transient"]
    assert run(daemon.poll_once()) is True
    job = run(tdb.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id}))
    assert job["completed_at"] is not None, job["error"]
    assert executor_threads() == []


def test_device_fault_quarantines_and_probe_reinstates(run, tdb, tmp_path,
                                                       video_job,
                                                       monkeypatch):
    """``device.fault`` on the first attempt: classified a device fault,
    the attempt refunded, the lease's device quarantined (no slot left,
    nothing claimed), the probe loop reinstates it, the retry completes."""
    video, job_id, _ = video_job
    monkeypatch.setattr(config, "DEVICE_PROBE_INTERVAL_S", 0.05)
    sched = MeshScheduler(devices=["cpu:0"], slots=1)
    quarantined = []
    orig_report = sched.report_device_fault

    def spy_report(lease, **kw):
        newly = orig_report(lease, **kw)
        quarantined.append((newly, sched.snapshot()["slots"]))
        return newly

    sched.report_device_fault = spy_report
    daemon = make_daemon(tdb, tmp_path, scheduler=sched,
                         poll_interval_s=0.02)
    failpoints.arm("device.fault", count=1)

    rows = run(run_until(daemon, tdb, lambda rs: all_terminal(
        [r for r in rs if r["kind"] == "transcode"])))
    job = next(r for r in rows if r["id"] == job_id)
    assert job["completed_at"] is not None, job["error"]
    assert job["attempt"] == 1           # the faulted attempt was refunded
    hist = run(claims.get_failure_history(tdb, job_id))
    assert [h["failure_class"] for h in hist] == ["device_fault"]
    assert "synthetic device.fault" in hist[0]["error"]
    assert quarantined == [(("cpu:0",), 0)]
    assert sched.quarantined_count() == 0 and sched.capacity() == 1
    assert daemon.breaker.consecutive_failures == 0
    assert not daemon.restart_requested


def test_device_fault_without_scheduler_trips_breaker(run, tdb, tmp_path,
                                                      video_job):
    """No lease, nothing to quarantine: the compute breaker counts it."""
    video, job_id, _ = video_job
    daemon = make_daemon(tdb, tmp_path)
    failpoints.arm("device.fault", count=1)
    assert run(daemon.poll_once()) is True
    job = run(tdb.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id}))
    assert job["attempt"] == 0 and job["failed_at"] is None
    assert daemon.breaker.consecutive_failures == 1
    hist = run(claims.get_failure_history(tdb, job_id))
    assert [h["failure_class"] for h in hist] == ["device_fault"]


def test_failed_probe_with_every_device_quarantined_restarts(run, tdb,
                                                             tmp_path,
                                                             monkeypatch):
    """ROADMAP Queue C item 15: a sticky CUDA error poisons the process,
    so the probe cannot pass in-process; with no slot left the daemon
    takes the restart verb's path (exit code 64 from ``_amain``)."""
    from vlog_tpu_torch.parallel import scheduler as sched_mod
    from vlog_tpu_torch.worker import mgmt

    monkeypatch.setattr(config, "DEVICE_PROBE_INTERVAL_S", 0.05)
    probes = []
    monkeypatch.setattr(sched_mod, "_default_probe",
                        lambda d: probes.append(d) or False)
    sched = MeshScheduler(devices=["cpu:0"], slots=1)
    ticket = sched.admit()
    sched.report_device_fault(ticket.acquire(), reason="sticky")
    ticket.close()
    daemon = make_daemon(tdb, tmp_path, scheduler=sched, poll_interval_s=0.02)

    async def go():
        await asyncio.wait_for(daemon.run(), 10.0)   # stops by itself

    run(go())
    assert daemon.restart_requested
    assert probes == ["cpu:0"]
    assert sched.snapshot()["slots"] == 0
    assert mgmt.RESTART_EXIT_CODE == 64


def test_every_device_quarantined_claims_nothing(run, tdb, tmp_path,
                                                video_job):
    """With every device quarantined (slots 0) the claim loop leaves the
    queue alone until a probe reinstates one (the JAX package's daemon
    falls back to a lease-less ``poll_once`` there, ROADMAP Queue C)."""
    video, job_id, _ = video_job
    sched = MeshScheduler(devices=["cpu:0"], slots=1)
    ticket = sched.admit()
    sched.report_device_fault(ticket.acquire(), reason="sick")
    ticket.close()
    daemon = make_daemon(tdb, tmp_path, scheduler=sched)
    assert run(daemon._poll_fill()) is False
    job = run(tdb.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id}))
    assert job["claimed_by"] is None and job["attempt"] == 0
    sched.probe_quarantined(probe_fn=lambda d: True)

    async def go():
        assert await daemon._poll_fill() is True
        await asyncio.gather(*daemon._tasks)

    run(go())
    assert run(vids.get_video(tdb, video["id"]))["status"] == "ready"


def test_failed_probe_with_a_slot_left_keeps_running(run, tdb, tmp_path,
                                                     monkeypatch):
    """One sick device of two: the healthy one keeps a slot, so a failed
    probe is no reason to restart."""
    from vlog_tpu_torch.parallel import scheduler as sched_mod

    monkeypatch.setattr(config, "DEVICE_PROBE_INTERVAL_S", 0.05)
    monkeypatch.setattr(sched_mod, "_default_probe", lambda d: False)
    sched = MeshScheduler(devices=["cpu:0", "cpu:1"], slots=2)
    t0, t1 = sched.admit(), sched.admit()
    lease0 = t0.acquire()
    t1.acquire()
    sched.report_device_fault(lease0, reason="sick")
    t0.close()
    t1.close()
    daemon = make_daemon(tdb, tmp_path, scheduler=sched, poll_interval_s=0.02)

    async def go():
        task = asyncio.create_task(daemon.run())
        await asyncio.sleep(0.4)
        assert not task.done()
        daemon.request_stop()
        await asyncio.wait_for(task, 10.0)

    run(go())
    assert not daemon.restart_requested
    assert sched.snapshot()["slots"] == 1


def test_transcription_job_under_the_scheduler(run, tdb, tmp_path,
                                               tiny_model_dir, monkeypatch):
    """A transcription job through the shared engine on the scheduler's
    device: ``captions.vtt``, the transcriptions row, the video's status,
    the span's window count; the engine's lease comes back."""
    import numpy as np

    from vlog_tpu_torch.asr.engine import reset_engine
    from vlog_tpu_torch.media.audio import AudioData, write_wav

    monkeypatch.setattr(config, "WHISPER_BEAM", 1)
    t = np.arange(3 * 16000) / 16000
    pcm = 0.2 * np.sin(2 * np.pi * 220.0 * t) * (0.6 + 0.4 * np.sin(
        2 * np.pi * 3.5 * t))
    wav = tmp_path / "speech.wav"
    write_wav(wav, AudioData(pcm=pcm[None].astype(np.float32),
                             sample_rate=16000))
    video = run(vids.create_video(tdb, "Speech", source_path=str(wav)))
    job_id = run(claims.enqueue_job(tdb, video["id"], JobKind.TRANSCRIPTION))
    sched = MeshScheduler(devices=["cpu"], slots=1)
    daemon = make_daemon(tdb, tmp_path, scheduler=sched,
                         transcription_model_dir=str(tiny_model_dir))

    async def go():
        assert await daemon._poll_fill() is True
        await asyncio.gather(*daemon._tasks)

    try:
        run(go())
    finally:
        reset_engine()
    job = run(tdb.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id}))
    assert job["completed_at"] is not None, job["error"]
    row = run(tdb.fetch_one("SELECT * FROM transcriptions"))
    assert row["status"] == "completed" and row["vtt_path"].endswith(
        "captions.vtt")
    assert (tmp_path / "videos" / video["slug"] / "captions.vtt").read_text() \
        .startswith("WEBVTT")
    assert run(vids.get_video(tdb, video["id"]))["transcription_status"] \
        == "completed"
    span = run(tdb.fetch_one(
        "SELECT * FROM job_spans WHERE job_id=:j AND name='worker.transcribe'",
        {"j": job_id}))
    assert json.loads(span["attributes"])["asr.windows_total"] == 1
    assert sched.capacity() == 1


def test_asr_engine_active_never_builds_the_engine(run, tdb, tmp_path,
                                                   monkeypatch):
    """With no capacity left, transcription is claimable only while the
    shared ASR engine is already serving; the claim loop never builds the
    engine (``_asr_engine_active`` peeks)."""
    from vlog_tpu_torch.asr import engine as engine_mod

    built = []
    monkeypatch.setattr(engine_mod, "get_engine",
                        lambda *a, **k: built.append(1))
    daemon = make_daemon(tdb, tmp_path)
    assert engine_mod.peek_engine() is None
    assert daemon._asr_engine_active() is False
    assert built == []


# --------------------------------------------------------------------------
# Failure plane (tests/test_failure_plane.py, test_self_healing.py)
# --------------------------------------------------------------------------

def test_daemon_startup_recovery_attributes_crash(run, tdb, tmp_path,
                                                  monkeypatch):
    monkeypatch.setattr(config, "RETRY_BACKOFF_BASE_S", 10.0)

    async def body():
        vid = await make_video(tdb)
        job_id = await claims.enqueue_job(tdb, vid)
        await claims.claim_job(tdb, "test-worker")
        await make_daemon(tdb, tmp_path).startup()
        hist = await claims.get_failure_history(tdb, job_id)
        assert [h["failure_class"] for h in hist] == ["worker_crash"]
        row = await tdb.fetch_one("SELECT * FROM jobs WHERE id=:id",
                                  {"id": job_id})
        assert row["attempt"] == 1
        assert row["next_retry_at"] is not None

    run(body())


def test_crash_recovery_release_dead_letters_final_attempt(run, tdb,
                                                           tmp_path):
    async def body():
        vid = await make_video(tdb)
        job_id = await claims.enqueue_job(tdb, vid, max_attempts=1)
        await claims.claim_job(tdb, "test-worker")
        await make_daemon(tdb, tmp_path).startup()
        row = await tdb.fetch_one("SELECT * FROM jobs WHERE id=:id",
                                  {"id": job_id})
        assert row["failed_at"] is not None and row["claimed_by"] is None
        hist = await claims.get_failure_history(tdb, job_id)
        assert [h["failure_class"] for h in hist] == ["worker_crash"]
        video = await tdb.fetch_one("SELECT * FROM videos WHERE id=:v",
                                    {"v": vid})
        assert video["status"] == "failed"

    run(body())


def test_data_failure_does_not_close_half_open_breaker(run, tdb, tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(config, "RETRY_BACKOFF_BASE_S", 0.0)
    daemon = make_daemon(
        tdb, tmp_path, name="bw3",
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=0.05))

    async def body():
        vid1 = await make_video(tdb, "sick")
        await claims.enqueue_job(tdb, vid1, max_attempts=1)

        async def boom(job, video):
            raise RuntimeError("backend sick")

        daemon._run_transcode = boom
        assert await daemon.poll_once() is True
        assert daemon.breaker.state is BreakerState.OPEN
        del daemon._run_transcode
        video2 = await vids.create_video(
            tdb, "Ghost", source_path=str(tmp_path / "missing.y4m"))
        await claims.enqueue_job(tdb, video2["id"], max_attempts=1)
        await asyncio.sleep(0.06)
        assert await daemon.poll_once() is True
        assert daemon.breaker.state is not BreakerState.CLOSED

    run(body())


def test_daemon_empty_queue_probe_does_not_wedge(run, tdb, tmp_path,
                                                 monkeypatch):
    monkeypatch.setattr(config, "RETRY_BACKOFF_BASE_S", 0.0)
    daemon = make_daemon(
        tdb, tmp_path, name="bw2",
        breaker=CircuitBreaker(failure_threshold=1, cooldown_s=0.05))

    async def boom(job, video):
        raise RuntimeError("sick")

    daemon._run_transcode = boom

    async def body():
        vid = await make_video(tdb)
        await claims.enqueue_job(tdb, vid, max_attempts=1)
        assert await daemon.poll_once() is True
        assert daemon.breaker.state is BreakerState.OPEN
        await asyncio.sleep(0.1)
        assert await daemon.poll_once() is False
        assert daemon.breaker.state is not BreakerState.HALF_OPEN
        vid2 = await make_video(tdb, "v2")
        jid2 = await claims.enqueue_job(tdb, vid2, max_attempts=2)

        async def ok(job, video):
            await claims.complete_job(tdb, job["id"], daemon.name)

        daemon._run_transcode = ok
        await asyncio.sleep(0.06)
        assert await daemon.poll_once() is True
        assert daemon.breaker.state is BreakerState.CLOSED
        row = await tdb.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                  {"i": jid2})
        assert row["completed_at"] is not None

    run(body())


def test_daemon_breaker_opens_then_recovers_via_probe(run, tdb, tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(config, "RETRY_BACKOFF_BASE_S", 0.0)
    outcomes = ["fail", "fail", "ok"]
    daemon = make_daemon(
        tdb, tmp_path, name="bw",
        breaker=CircuitBreaker(failure_threshold=2, cooldown_s=0.15))

    async def scripted(job, video):
        if outcomes.pop(0) == "fail":
            raise RuntimeError("backend sick")
        await claims.complete_job(tdb, job["id"], daemon.name)

    daemon._run_transcode = scripted

    async def body():
        vid = await make_video(tdb)
        job_id = await claims.enqueue_job(tdb, vid, max_attempts=10)
        assert await daemon.poll_once() is True
        assert daemon.breaker.state is BreakerState.CLOSED
        assert await daemon.poll_once() is True
        assert daemon.breaker.state is BreakerState.OPEN
        assert await daemon.poll_once() is False
        await asyncio.sleep(0.2)
        assert await daemon.poll_once() is True
        assert daemon.breaker.state is BreakerState.CLOSED
        hist = await claims.get_failure_history(tdb, job_id)
        assert [h["failure_class"] for h in hist] == ["transient",
                                                      "transient"]

    run(body())


def test_watchdog_cancels_no_progress_compute(run, tdb, tmp_path):
    daemon = make_daemon(tdb, tmp_path, stall_window_s=0.2,
                         watchdog_tick_s=0.02)

    def stuck():
        while not daemon._cancel.is_set():
            time.sleep(0.01)
        raise JobCancelled(daemon._cancel_reason)

    async def body():
        daemon._progress_marker = time.monotonic()
        with pytest.raises(JobCancelled, match="stalled"):
            await daemon._run_with_timeout(stuck, 30.0, "transcode")

    run(body())


def test_stall_is_classified_stalled(run, tdb, tmp_path, monkeypatch):
    monkeypatch.setattr(config, "RETRY_BACKOFF_BASE_S", 0.0)
    daemon = make_daemon(tdb, tmp_path, stall_window_s=0.15,
                         watchdog_tick_s=0.02, cancel_grace_s=5.0)

    async def wedged(job, video):
        def work():
            while not daemon._cancel.is_set():
                time.sleep(0.01)
            raise JobCancelled(daemon._cancel_reason)
        await daemon._run_with_timeout(work, 30.0, "transcode")

    daemon._run_transcode = wedged

    async def body():
        vid = await make_video(tdb)
        job_id = await claims.enqueue_job(tdb, vid, max_attempts=3)
        assert await daemon.poll_once() is True
        hist = await claims.get_failure_history(tdb, job_id)
        assert [h["failure_class"] for h in hist] == ["stalled"]
        row = await tdb.fetch_one("SELECT * FROM jobs WHERE id=:id",
                                  {"id": job_id})
        assert row["failed_at"] is None

    run(body())


class ChaosDaemon(WorkerDaemon):
    """A daemon whose transcode handler is a tiny fake compute that
    passes through the backend failpoint site."""

    async def _run_transcode(self, job, video):
        failpoints.hit("backend.encode")
        await asyncio.sleep(0.001)
        if json.loads(job["payload"] or "{}").get("poison"):
            raise RuntimeError("poison pill: crashes every attempt")
        await claims.complete_job(self.db, job["id"], self.name)
        self.stats.completed += 1


def test_chaos_convergence_with_six_failpoint_sites(run, tdb, tmp_path,
                                                    monkeypatch):
    monkeypatch.setattr(config, "RETRY_BACKOFF_BASE_S", 0.02)
    monkeypatch.setattr(config, "RETRY_BACKOFF_CAP_S", 0.1)
    monkeypatch.setattr(config, "CLAIM_LEASE_S", 1.0)

    async def body():
        jobs = {}
        for i in range(6):
            vid = await make_video(tdb, f"chaos-{i}")
            poison = i == 5
            jobs[await claims.enqueue_job(
                tdb, vid, max_attempts=3 if poison else 6,
                payload={"poison": True} if poison else None)] = poison
        daemons = [
            ChaosDaemon(tdb, name=f"chaos-w{i}", device="cpu",
                        video_dir=tmp_path / "videos", poll_interval_s=0.02,
                        heartbeat_interval_s=30.0,
                        breaker=CircuitBreaker(failure_threshold=4,
                                               cooldown_s=0.05))
            for i in range(2)]
        tasks = [asyncio.create_task(d.run()) for d in daemons]
        await asyncio.sleep(0.05)
        failpoints.arm_from_spec(
            "claims.claim=2,claims.complete=2,claims.fail=1,"
            "db.commit=2,daemon.compute=2,backend.encode=2")
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            rows = await tdb.fetch_all("SELECT * FROM jobs")
            if all_terminal(rows):
                break
            await asyncio.sleep(0.05)
        for d in daemons:
            d.request_stop()
        await asyncio.gather(*tasks, return_exceptions=True)
        rows = {r["id"]: r for r in await tdb.fetch_all("SELECT * FROM jobs")}
        for job_id, poison in jobs.items():
            r = rows[job_id]
            assert (r["completed_at"] is not None) ^ (r["failed_at"]
                                                      is not None), r
            assert r["claimed_by"] is None
            hist = await claims.get_failure_history(tdb, job_id)
            if poison:
                assert r["failed_at"] is not None
                assert len(hist) >= r["max_attempts"]
            if r["completed_at"] is not None:
                assert r["progress"] == 100.0
        fired = {s: c["fires"] for s, c in failpoints.counters().items()}
        assert sum(fired.values()) >= 5, fired
        assert sum(1 for v in fired.values() if v) >= 3, fired

    run(body())


def test_daemon_brownout_on_db_claim_failures(run, tdb, tmp_path):
    src = make_y4m(tmp_path / "b.y4m", n_frames=6, width=64, height=48)
    video = run(vids.create_video(tdb, "Brownout", source_path=str(src)))
    job_id = run(claims.enqueue_job(tdb, video["id"], JobKind.SPRITE))
    run(tdb.execute("UPDATE videos SET duration_s=0.25 WHERE id=:i",
                    {"i": video["id"]}))
    daemon = make_daemon(
        tdb, tmp_path, poll_interval_s=0.05,
        db_breaker=CoordinationBreaker(threshold=2, cooldown_s=0.05,
                                       base_backoff_s=0.01))
    failpoints.arm("db.claim", count=3)

    async def go():
        task = asyncio.create_task(daemon.run())
        for _ in range(400):
            if daemon.db_breaker.is_open:
                break
            await asyncio.sleep(0.01)
        assert daemon.db_breaker.is_open, "brownout breaker never opened"
        for _ in range(1000):
            row = await tdb.fetch_one("SELECT * FROM jobs WHERE id=:id",
                                      {"id": job_id})
            if row["completed_at"] is not None:
                break
            await asyncio.sleep(0.02)
        daemon.request_stop()
        await asyncio.wait_for(task, timeout=30.0)
        assert row["completed_at"] is not None
        assert not daemon.db_breaker.is_open
        assert daemon.db_breaker.opens == 1

    run(go())
    from vlog_tpu_torch.obs.metrics import HAVE_PROMETHEUS, runtime

    if HAVE_PROMETHEUS:
        assert ('vlog_claim_errors_total{source="daemon"}'
                in runtime().render_text())


# --------------------------------------------------------------------------
# Drain (tests/test_preemption.py)
# --------------------------------------------------------------------------

def slow_compute(monkeypatch):
    """The transcode pipeline replaced by an endless cooperative loop."""
    import vlog_tpu_torch.worker.pipeline as pl

    def fake(source, out_dir, **kw):
        cb = kw.get("progress_cb")
        i = 0
        while True:
            i += 1
            if cb:
                cb(i, 10_000, "grinding")
            time.sleep(0.01)

    monkeypatch.setattr(pl, "process_video", fake)


def test_drain_gates_claiming_and_marks_status(run, tdb, tmp_path, video_job):
    daemon = make_daemon(tdb, tmp_path, drain_grace_s=30.0, drain_tick_s=0.02)

    async def go():
        assert daemon.begin_drain("test notice")
        assert await daemon.poll_once() is False
        await daemon._heartbeat()
        await asyncio.wait_for(daemon._drain_task, 5.0)

    run(go())
    row = run(tdb.fetch_one("SELECT status FROM workers WHERE name=:n",
                            {"n": daemon.name}))
    assert row["status"] == "draining"
    assert daemon._stop.is_set()
    assert run(tdb.fetch_one("SELECT claimed_by FROM jobs"))["claimed_by"] \
        is None


def test_drain_deadline_bounded_and_preempted_requeue(run, tdb, tmp_path,
                                                      video_job,
                                                      monkeypatch):
    video, job_id, _ = video_job
    slow_compute(monkeypatch)
    daemon = make_daemon(tdb, tmp_path, drain_grace_s=0.3, drain_tick_s=0.02)

    async def go():
        task = asyncio.create_task(daemon.poll_once())
        while job_id not in daemon._active_sups:
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.05)
        t0 = time.monotonic()
        daemon.handle_termination()
        assert daemon.drain.active
        assert await asyncio.wait_for(task, 10.0) is True
        await asyncio.wait_for(daemon._drain_task, 10.0)
        return time.monotonic() - t0

    assert run(go()) < 0.3 + 3.0
    job = run(tdb.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id}))
    assert job["claimed_by"] is None and job["attempt"] == 0
    assert job["next_retry_at"] is None
    hist = run(claims.get_failure_history(tdb, job_id))
    assert hist[-1]["failure_class"] == FailureClass.PREEMPTED.value
    assert DRAIN_CANCEL_REASON in hist[-1]["error"]
    assert js.is_claimable(job, now=time.time())


def test_second_sigterm_skips_grace(run, tdb, tmp_path, video_job,
                                    monkeypatch):
    video, job_id, _ = video_job
    slow_compute(monkeypatch)
    daemon = make_daemon(tdb, tmp_path, drain_grace_s=600.0,
                         drain_tick_s=0.02)

    async def go():
        task = asyncio.create_task(daemon.poll_once())
        while job_id not in daemon._active_sups:
            await asyncio.sleep(0.01)
        daemon.handle_termination()
        assert daemon.drain.active and not daemon._stop.is_set()
        t0 = time.monotonic()
        daemon.handle_termination()
        assert daemon._stop.is_set()
        await asyncio.wait_for(task, 10.0)
        await asyncio.wait_for(daemon._drain_task, 10.0)
        return time.monotonic() - t0

    assert run(go()) < 3.0
    assert daemon.stats.released == 1
    job = run(tdb.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id}))
    assert job["claimed_by"] is None and job["attempt"] == 0


def test_drain_extends_lease_sweep_cannot_reclaim(run, tdb, tmp_path,
                                                  video_job, monkeypatch):
    video, job_id, _ = video_job
    slow_compute(monkeypatch)
    daemon = make_daemon(tdb, tmp_path, drain_grace_s=600.0,
                         drain_tick_s=0.02)

    async def go():
        task = asyncio.create_task(daemon.poll_once())
        while job_id not in daemon._active_sups:
            await asyncio.sleep(0.01)
        daemon.begin_drain("lease test")
        await tdb.execute("UPDATE jobs SET claim_expires_at=:e WHERE id=:id",
                          {"e": time.time() + 0.5, "id": job_id})
        await daemon._extend_drain_leases()
        assert await claims.sweep_expired_claims(tdb) == 0
        row = await tdb.fetch_one("SELECT * FROM jobs WHERE id=:id",
                                  {"id": job_id})
        assert row["claimed_by"] == daemon.name
        assert row["claim_expires_at"] > time.time() + 60
        daemon.request_stop()
        await asyncio.wait_for(task, 10.0)
        await asyncio.wait_for(daemon._drain_task, 10.0)

    run(go())


def test_drain_command_and_stats_surface(run, tdb, tmp_path):
    daemon = make_daemon(tdb, tmp_path, drain_grace_s=45.0, drain_tick_s=0.02)

    async def go():
        cmd_id = await cmds.send_command(tdb, daemon.name, "drain")
        assert await cmds.drain_for_worker(tdb, daemon.name,
                                           daemon.handle_command) == 1
        resp = (await cmds.get_command(tdb, cmd_id))["response"]
        assert resp["draining"] and resp["started"] and resp["grace_s"] == 45.0
        stats = await daemon.handle_command("stats", {})
        assert stats["draining"]["active"]
        assert stats["draining"]["jobs_remaining"] == 0
        assert stats["mesh"] is None
        await asyncio.wait_for(daemon._drain_task, 5.0)

    run(go())


def test_drain_readiness_degrades(run):
    from vlog_tpu_torch.worker.health import drain_check

    st = DrainState()
    check = drain_check(st)
    assert run(check())[0]
    st.begin("eviction notice", 30.0)
    ok, detail = run(check())
    assert not ok and "draining" in detail and "grace left" in detail


# --------------------------------------------------------------------------
# Commands (tests/test_commands.py)
# --------------------------------------------------------------------------

def test_daemon_answers_commands_on_heartbeat(run, tdb, tmp_path):
    sched = MeshScheduler(devices=["cpu:0"], slots=1)
    daemon = make_daemon(tdb, tmp_path, name="cmdw", scheduler=sched,
                         heartbeat_interval_s=0.05, poll_interval_s=0.05)

    async def go():
        ping_id = await cmds.send_command(tdb, "cmdw", "ping")
        stats_id = await cmds.send_command(tdb, "cmdw", "stats")
        stop_id = await cmds.send_command(tdb, "cmdw", "stop")
        await asyncio.wait_for(daemon.run(), 10.0)
        assert (await cmds.get_command(tdb, ping_id))["response"]["pong"]
        stats = (await cmds.get_command(tdb, stats_id))["response"]
        assert stats["claimed"] == 0 and "transcode" in stats["kinds"]
        assert stats["mesh"]["slots"] == 1 and stats["mesh"]["devices"] == 1
        assert (await cmds.get_command(tdb, stop_id))["response"]["stopping"]

    run(go())


def test_get_logs_and_metrics_verbs(run, tdb, tmp_path):
    import logging

    daemon = make_daemon(tdb, tmp_path, name="mgmtw")

    async def go():
        logging.getLogger("vlog.test").warning("breadcrumb-xyzzy")
        logs = await daemon.handle_command("get_logs", {"lines": 50})
        assert any("breadcrumb-xyzzy" in ln for ln in logs["lines"])
        errlogs = await daemon.handle_command(
            "get_logs", {"lines": 50, "level": "error"})
        assert not any("breadcrumb-xyzzy" in ln for ln in errlogs["lines"])
        m = await daemon.handle_command("get_metrics", {})
        assert m["worker"] == "mgmtw"
        assert m["rss_mb"] > 0 and m["threads"] >= 1
        # CUDA never initialized in a CPU test process
        assert m["device"] == {"initialized": False}
        up = await daemon.handle_command("update", {})
        assert "not supported" in up["error"]
        prof = await daemon.handle_command("profile", {"action": "status"})
        assert prof["profiling"] is False
        bad = await daemon.handle_command("profile", {"action": "bogus"})
        assert "unknown profile action" in bad["error"]
        assert "unknown command" in (
            await daemon.handle_command("nope", {}))["error"]

    run(go())


def test_restart_verb_sets_exit_contract(run, tdb, tmp_path):
    daemon = make_daemon(tdb, tmp_path, name="rstw",
                         heartbeat_interval_s=0.05, poll_interval_s=0.05)

    async def go():
        rid = await cmds.send_command(tdb, "rstw", "restart")
        await asyncio.wait_for(daemon.run(), 10.0)
        resp = (await cmds.get_command(tdb, rid))["response"]
        assert resp["restarting"] and resp["exit_code"] == 64
        assert daemon.restart_requested

    run(go())
