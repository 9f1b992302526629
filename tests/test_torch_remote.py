"""The port's remote worker (``vlog_tpu_torch.worker.remote``) over HTTP on
the CPU: ``RemoteWorker(device="cpu")`` with a CPU ``TorchBackend``,
against the JAX package's Worker API server and the port's.

Parity: the reference's ``RemoteWorker`` (``JaxBackend`` pinned to one
device) against the reference's server is the oracle. On the same source
(the 96x128 Y4M of ``tests/test_torch_daemon_parity.py``: 10 frames at
24 fps, whose sprite tile resizes alike in both packages) the port's
worker leaves the server a tree byte-identical to the reference worker's,
against either server, except the rate-control journal's float ``cost``
fields (relative 1e-5, ROADMAP Queue C item 2); the rows of ``videos``,
``jobs``, ``video_qualities``, ``quality_progress``, ``job_failures`` and
``workers`` are equal except times, the temporary root in stored paths,
the workers' ``capabilities`` and the jobs' ``last_checkpoint`` (the
uploader's incremental inventory: its last value depends on the timing
of the streaming poll against the compute, in either package).

Cross-worker resume (20 frames at 10 fps, 1 s segments, one 10-frame
chain per dispatch, preempted after dispatch 1 through the
``preempt.notice`` failpoint and a 0 s drain grace): a reference worker
preempted and the port's resuming leaves the uninterrupted tree; so does
the reverse with ``gop_mode="intra"``. With I+P chains the reference
restarts ``idr_pic_id`` when it resumes (ROADMAP Queue C item 5), so its
resume of the port's partial tree is held to its resume of its own.

The rest runs the port's worker against the port's server (the reference
scenarios of ``tests/test_worker_api.py``, ``test_storage_integrity.py``,
``test_preemption.py`` and ``test_commands.py`` that involve a worker).
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import threading
import time
from pathlib import Path

import pytest

from tests.fixtures.media import make_y4m
from tests.test_torch_backend import (JOURNAL, _files,  # noqa: F401
                                      assert_journals_match, one_torch_thread)
from tests.test_torch_daemon_parity import _normalize, sources  # noqa: F401
from tests.test_torch_worker_api import Env, _start, _stop

TABLES = ("videos", "jobs", "video_qualities", "quality_progress",
          "job_failures", "workers")


@pytest.fixture(autouse=True)
def _quiet_planes(monkeypatch):
    """Both packages: no retry pacing, fresh failpoints, and the JAX
    backend on one device (its trees are the single-device ones)."""
    from vlog_tpu.parallel import scheduler
    from vlog_tpu.utils import failpoints as jfp
    from vlog_tpu_torch.utils import failpoints as tfp

    for pkg in ("vlog_tpu", "vlog_tpu_torch"):
        cfg = importlib.import_module(f"{pkg}.config")
        monkeypatch.setattr(cfg, "RETRY_BACKOFF_BASE_S", 0.0)
    monkeypatch.setattr(scheduler, "grid_for_run", lambda *a, **k: None)
    for fp in (jfp, tfp):
        fp.reset()
    yield
    for fp in (jfp, tfp):
        fp.reset()


def port_worker(env: Env, work: Path, only: str | None = None, **kw):
    """The port's worker on the CPU (``only``: claim that one kind)."""
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.enums import JobKind
    from vlog_tpu_torch.worker.remote import RemoteWorker, WorkerAPIClient

    kw.setdefault("backend", TorchBackend(device="cpu"))
    if only:
        kw["kinds"] = (JobKind(only),)
    return RemoteWorker(WorkerAPIClient(env.base, env.key, timeout=30.0,
                                        retries=1),
                        name="rw1", work_dir=work, device="cpu",
                        progress_min_interval_s=0.0, claim_wait_s=0.0, **kw)


def ref_worker(env: Env, work: Path, only: str | None = None, **kw):
    """The reference's worker (``JaxBackend``)."""
    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu.enums import JobKind
    from vlog_tpu.worker.remote import RemoteWorker, WorkerAPIClient

    kw.setdefault("backend", JaxBackend())
    if only:
        kw["kinds"] = (JobKind(only),)
    return RemoteWorker(WorkerAPIClient(env.base, env.key, timeout=30.0,
                                        retries=1),
                        name="rw1", work_dir=work,
                        progress_min_interval_s=0.0, claim_wait_s=0.0, **kw)


async def drain(worker, limit: int = 10) -> int:
    """poll_once until the queue is empty; returns the jobs run."""
    ran = 0
    try:
        while ran < limit and await worker.poll_once():
            ran += 1
    finally:
        await worker.client.aclose()
    return ran


async def rows_of(env: Env) -> dict:
    return {t: [dict(r) for r in await env.db.fetch_all(
        f"SELECT * FROM {t} ORDER BY 1")] for t in TABLES}


async def enqueue(env: Env, title: str, src: Path, kind: str = "transcode",
                  payload: dict | None = None) -> tuple[dict, int]:
    v = await env.mod["vids"].create_video(env.db, title, source_path=str(src),
                                           size_bytes=src.stat().st_size)
    jid = await env.mod["claims"].enqueue_job(
        env.db, v["id"], env.mod["enums"].JobKind(kind), payload=payload)
    return v, jid


def _tree(env: Env, video: dict) -> Path:
    return env.video_dir / video["slug"]


def assert_trees_equal(want: Path, got: Path) -> None:
    w, g = _files(want), _files(got)
    assert set(g) == set(w)
    for rel, data in g.items():
        if rel == JOURNAL:
            assert_journals_match(w[rel], data)
        else:
            assert data == w[rel], f"{rel} differs"


def assert_rows_equal(want: dict, got: dict, label: str) -> None:
    """Equal rows, except ``jobs.last_checkpoint``: the streaming
    uploader's incremental inventory, whose last value depends on how
    many poll cycles shipped files before the compute ended (timing, in
    either package); it is held to its shape instead."""
    for row in got["jobs"]:
        ckpt = json.loads(row["last_checkpoint"] or "{}")
        assert set(ckpt) in (set(), {"files", "bytes"}), ckpt
    diffs = [(t, i, k, w.get(k), g.get(k))
             for t in TABLES for i, (w, g) in enumerate(zip(want[t], got[t]))
             for k in w.keys() | g.keys()
             if w.get(k) != g.get(k) and k != "last_checkpoint"]
    assert not diffs and all(len(want[t]) == len(got[t]) for t in TABLES), \
        (label, diffs)


# --------------------------------------------------------------------------
# Parity: the server's tree and rows
# --------------------------------------------------------------------------

def test_port_worker_leaves_the_reference_workers_tree_and_rows(
        run, tmp_path, sources):  # noqa: F811
    """Transcode + the sprite job its finalize enqueues, drained by one
    worker: (reference worker, reference server), (port worker,
    reference server), (port worker, port server)."""
    src = sources["transcode"]
    out = {}
    for label, server_pkg, make in (("jax", "vlog_tpu", ref_worker),
                                    ("port@jax", "vlog_tpu", port_worker),
                                    ("port@port", "vlog_tpu_torch",
                                     port_worker)):
        async def go():
            env = await _start(server_pkg, tmp_path / label)
            try:
                video, _ = await enqueue(env, "Remote Video", src)
                worker = make(env, tmp_path / label / "work")
                ran = await drain(worker)
                assert not (tmp_path / label / "work"
                            / video["slug"]).exists()
                return env, video, ran, await rows_of(env)
            finally:
                await _stop(env)
        env, video, ran, rows = run(go())
        out[label] = (_tree(env, video), ran, _normalize(rows, env.tmp))
    (jtree, jran, jrows) = out["jax"]
    assert jran == 2
    assert [r["kind"] for r in jrows["jobs"]] == ["transcode", "sprite"]
    assert all(r["progress"] == 100.0 and r["error"] is None
               for r in jrows["jobs"]), jrows["jobs"]
    assert jrows["videos"][0]["status"] == "ready"
    for label in ("port@jax", "port@port"):
        tree, ran, rows = out[label]
        assert ran == 2, label
        assert_trees_equal(jtree, tree)
        assert_rows_equal(jrows, rows, label)
    files = _files(out["port@port"][0])
    for must in ("master.m3u8", "manifest.mpd", "360p/init.mp4",
                 "thumbnail.jpg", "sprites/sprite_01.jpg", "outputs.json",
                 JOURNAL):
        assert must in files, must


# --------------------------------------------------------------------------
# Job kinds over HTTP (the port's worker and server)
# --------------------------------------------------------------------------

def test_h265_reencode_over_http(run, tmp_path, sources):  # noqa: F811
    from vlog_tpu_torch.enums import JobKind

    async def go():
        env = await _start("vlog_tpu_torch", tmp_path / "srv")
        try:
            video, jid = await enqueue(env, "Upgrade", sources["hevc"],
                                       "reencode", {"codec": "h265"})
            worker = port_worker(env, tmp_path / "work",
                                 kinds=(JobKind.REENCODE,))
            assert await drain(worker) == 1
            job = await env.db.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                         {"i": jid})
            row = await env.mod["vids"].get_video(env.db, video["id"])
            return job, row, _tree(env, video)
        finally:
            await _stop(env)

    job, row, tree = run(go())
    assert job["completed_at"] is not None, job["error"]
    assert row["codec"] == "h265"
    master = (tree / "master.m3u8").read_text()
    assert "hvc1" in master and "avc1" not in master
    assert b"hvcC" in (tree / "360p" / "init.mp4").read_bytes()


@pytest.mark.parametrize("server", ["vlog_tpu", "vlog_tpu_torch"])
def test_unknown_codec_rejected(run, tmp_path, server):
    from vlog_tpu_torch.enums import JobKind

    src = make_y4m(tmp_path / "r.y4m", n_frames=6, width=64, height=48)

    async def go():
        env = await _start(server, tmp_path / "srv")
        try:
            _, jid = await enqueue(env, "Bad", src, "reencode",
                                   {"codec": "vp8"})
            worker = port_worker(env, tmp_path / "work",
                                 kinds=(JobKind.REENCODE,))
            await drain(worker)
            return await env.db.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                          {"i": jid})
        finally:
            await _stop(env)

    job = run(go())
    assert job["failed_at"] is not None
    assert "has no encoder" in job["error"]


@pytest.mark.parametrize("server", ["vlog_tpu", "vlog_tpu_torch"])
def test_streaming_uploader_overlaps_and_defers_manifests(run, tmp_path,
                                                          server):
    """Segments ship while the "transcode" runs, manifests wait for
    drain(), the rc journal too; a fresh uploader resumes from the
    server's inventory. Every poll cycle that shipped posts a checkpoint
    that lands in the job row (incremental checkpoints)."""
    from vlog_tpu_torch.worker.remote import (StreamingUploader,
                                              WorkerAPIClient)

    src = make_y4m(tmp_path / "s.y4m", n_frames=4, width=64, height=48)
    root = tmp_path / "out"
    (root / "360p").mkdir(parents=True)
    (root / "360p" / "segment_00001.m4s").write_bytes(b"a" * 100)
    (root / "master.m3u8").write_text("#EXTM3U")
    (root / JOURNAL).write_text("{}\n")

    async def go():
        env = await _start(server, tmp_path / "srv")
        client = WorkerAPIClient(env.base, env.key, timeout=30.0, retries=1)
        try:
            video, jid = await enqueue(env, "Stream", src)
            await client.claim(["transcode"], "tpu")
            posted = []

            async def checkpoint(summary):
                posted.append(summary)
                await client.progress(jid, checkpoint=summary)

            up = StreamingUploader(client, video["id"], root, poll_s=0.1,
                                   on_checkpoint=checkpoint)
            task = asyncio.create_task(up.run())
            await asyncio.sleep(0.3)
            assert up.uploaded == {"360p/segment_00001.m4s"}
            (root / "360p" / "segment_00002.m4s").write_bytes(b"b" * 50)
            await asyncio.sleep(0.5)
            assert "360p/segment_00002.m4s" in up.uploaded
            assert posted == [{"files": 1, "bytes": 100},
                              {"files": 2, "bytes": 150}]
            row = await env.db.fetch_one(
                "SELECT last_checkpoint FROM jobs WHERE id=:i", {"i": jid})
            assert json.loads(row["last_checkpoint"]) == posted[-1]
            up.stop()
            await task
            await up.drain()
            assert {"master.m3u8", JOURNAL} <= up.uploaded
            manifest = json.loads((root / "outputs.json").read_text())
            assert set(manifest["files"]) == {
                "360p/segment_00001.m4s", "360p/segment_00002.m4s",
                "master.m3u8"}
            tree = _tree(env, video)
            assert (tree / "outputs.json").read_bytes() == \
                (root / "outputs.json").read_bytes()
            up2 = StreamingUploader(client, video["id"], root)
            await up2.resume_state()
            # the journal and the manifest never resume
            assert up2.uploaded == up.uploaded - {JOURNAL}
        finally:
            await client.aclose()
            await _stop(env)

    run(go())


@pytest.mark.parametrize("server", ["vlog_tpu", "vlog_tpu_torch"])
def test_claim_fence_failpoint_with_the_port_client(run, tmp_path, server):
    from vlog_tpu_torch.utils import failpoints
    from vlog_tpu_torch.worker.remote import ClaimLost, WorkerAPIClient

    src = make_y4m(tmp_path / "c.y4m", n_frames=4, width=64, height=48)

    async def go():
        env = await _start(server, tmp_path / "srv")
        client = WorkerAPIClient(env.base, env.key, timeout=30.0, retries=1)
        try:
            _, jid = await enqueue(env, "Forced", src)
            claimed = await client.claim(["transcode"], "tpu")
            assert claimed["job"]["id"] == jid
            await client.progress(jid, progress=5.0)
            failpoints.arm("claim.fence", count=1)
            with pytest.raises(ClaimLost, match="stale claim epoch"):
                await client.progress(jid, progress=9.0)
            assert client._epochs[jid] == 1
            await client.progress(jid, progress=12.0)
            return await env.db.fetch_one(
                "SELECT progress FROM jobs WHERE id=:i", {"i": jid})
        finally:
            await client.aclose()
            await _stop(env)

    assert run(go())["progress"] == 12.0


@pytest.mark.parametrize("client_pkg,server", [
    ("vlog_tpu_torch", "vlog_tpu"), ("vlog_tpu", "vlog_tpu_torch")])
def test_streamed_uploads_are_chunked_both_ways(run, tmp_path, client_pkg,
                                                server):
    """The port's client (aiohttp) to the reference's server and the
    reference's client (httpx) to the port's: both stream the file with
    chunked transfer encoding, and the server publishes the same bytes
    and digest."""
    import hashlib

    from aiohttp import web

    client_mod = importlib.import_module(f"{client_pkg}.worker.remote")
    data = bytes(range(256)) * 5000            # > one 1 MiB upload chunk
    src = tmp_path / "blob.bin"
    src.write_bytes(data)
    seen = []

    @web.middleware
    async def record(request, handler):
        if request.method == "PUT":
            seen.append(request.headers.get("Transfer-Encoding"))
        return await handler(request)

    async def go():
        env = await _start(server, tmp_path / "srv", middleware=record)
        client = client_mod.WorkerAPIClient(env.base, env.key, timeout=30.0,
                                            retries=0)
        try:
            video, _ = await enqueue(env, "Chunked", make_y4m(
                tmp_path / "c.y4m", n_frames=4, width=64, height=48))
            await client.claim(["transcode"], "tpu")
            digest = await client.upload_file(video["id"], "360p/blob.bin",
                                              src)
            return digest, (_tree(env, video) / "360p" / "blob.bin")
        finally:
            await client.aclose()
            await _stop(env)

    digest, dest = run(go())
    assert seen == ["chunked"]
    assert dest.read_bytes() == data
    assert digest == hashlib.sha256(data).hexdigest()


def test_upload_corrupt_failpoint_is_caught_and_retried(run, tmp_path):
    """upload.corrupt bit-flips the wire bytes while the digest header
    carries the truth: the port's server answers 422, the port's client
    retries with a clean body, the file publishes intact."""
    from vlog_tpu_torch.api.worker_api import METRICS
    from vlog_tpu_torch.utils import failpoints
    from vlog_tpu_torch.worker.remote import WorkerAPIClient

    src = make_y4m(tmp_path / "u.y4m", n_frames=4, width=64, height=48)

    async def go():
        env = await _start("vlog_tpu_torch", tmp_path / "srv")
        client = WorkerAPIClient(env.base, env.key, timeout=30.0, retries=2)
        try:
            video, _ = await enqueue(env, "Corrupt", src)
            await client.claim(["transcode"], "tpu")
            failpoints.arm("upload.corrupt", count=1)
            await client.upload_file(video["id"], "360p/init.mp4", src)
            dest = _tree(env, video) / "360p" / "init.mp4"
            assert dest.read_bytes() == src.read_bytes()
            assert env.app[METRICS].upload_digest_mismatch._value.get() == 1
            assert not list(_tree(env, video).rglob("*.part"))
        finally:
            await client.aclose()
            await _stop(env)

    run(go())


def _executor_threads() -> list[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith(("vlog-pipe", "vlog-decode"))]


def test_claim_lost_stops_at_a_batch_boundary(run, tmp_path, monkeypatch):
    """The lease is swept and the job reclaimed by another worker after
    dispatch 1: the next progress post gets 409, and the run stops at the
    following batch boundary with no executor thread left."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.worker.remote import ClaimLost

    monkeypatch.setattr(config, "SEGMENT_DURATION_S", 1.0)
    monkeypatch.setattr(config, "TPU_FRAME_BATCH", 10)
    src = make_y4m(tmp_path / "l.y4m", n_frames=30, width=128, height=96,
                   fps=10)
    seen: dict = {"done": [], "lost_at": None}

    async def go():
        env = await _start("vlog_tpu_torch", tmp_path / "srv")
        try:
            video, jid = await enqueue(env, "Lost", src)
            worker = port_worker(env, tmp_path / "work")
            loop = asyncio.get_running_loop()
            make_cb, progress = worker._make_progress_cb, \
                worker.client.progress

            async def spy_progress(job_id, **kw):
                try:
                    return await progress(job_id, **kw)
                except ClaimLost:
                    seen["lost_at"] = seen["lost_at"] or time.monotonic()
                    raise

            def hooked(job_id, rung_names):
                cb = make_cb(job_id, rung_names)

                def wrapped(done, total, msg):
                    seen["done"].append(done)
                    if len(seen["done"]) == 1:
                        asyncio.run_coroutine_threadsafe(
                            env.lapse_and_steal(job_id), loop).result(30)
                    elif len(seen["done"]) == 2:
                        deadline = time.monotonic() + 30
                        while seen["lost_at"] is None \
                                and time.monotonic() < deadline:
                            time.sleep(0.01)
                    return cb(done, total, msg)
                return wrapped

            worker.client.progress = spy_progress
            worker._make_progress_cb = hooked
            assert await drain(worker, limit=1) == 1
            job = await env.db.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                         {"i": jid})
            return worker, job, _tree(env, video)
        finally:
            await _stop(env)

    worker, job, tree = run(go())
    assert seen["lost_at"] is not None
    assert seen["done"][:2] == [10, 20]       # stopped at dispatch 2's end
    assert job["claimed_by"] == "thief" and job["completed_at"] is None
    assert "claim lost" in (worker.stats.last_error or "")
    assert _executor_threads() == []
    assert not (tree / "master.m3u8").exists()


def test_commands_and_mgmt_verbs_over_http(run, tmp_path):
    from vlog_tpu_torch.jobs import commands as cmds
    from vlog_tpu_torch.worker.mgmt import RESTART_EXIT_CODE

    async def go():
        env = await _start("vlog_tpu_torch", tmp_path / "srv")
        try:
            ids = {}
            for verb in ("ping", "stats", "get_metrics", "get_logs",
                         "update", "restart"):
                ids[verb] = await cmds.send_command(env.db, "rw1", verb, {})
            worker = port_worker(env, tmp_path / "work",
                                 heartbeat_interval_s=0.1,
                                 poll_interval_s=0.1)
            await asyncio.wait_for(worker.run(), 30)
            await worker.client.aclose()
            out = {v: (await cmds.get_command(env.db, i))["response"]
                   for v, i in ids.items()}
            return worker, {v: json.loads(r) if isinstance(r, str) else r
                            for v, r in out.items()}
        finally:
            await _stop(env)

    worker, resp = run(go())
    assert resp["ping"] == {"pong": True, "worker": "rw1"}
    assert resp["stats"]["kinds"] == ["transcode", "sprite", "transcription"]
    assert resp["stats"]["draining"]["jobs_remaining"] == 0
    assert resp["get_metrics"]["worker"] == "rw1"
    assert "lines" in resp["get_logs"] or "logs" in resp["get_logs"]
    assert "not supported" in resp["update"]["error"]
    assert "unknown command" in run(worker.handle_command("bogus", {}))[
        "error"]
    assert resp["restart"] == {"restarting": True,
                               "exit_code": RESTART_EXIT_CODE}
    assert worker.restart_requested


def test_disk_pressure_pauses_claiming(run, tmp_path, monkeypatch):
    from vlog_tpu_torch import config

    src = make_y4m(tmp_path / "d.y4m", n_frames=4, width=64, height=48)

    async def go():
        env = await _start("vlog_tpu_torch", tmp_path / "srv")
        try:
            _, jid = await enqueue(env, "Disk", src, "sprite")
            worker = port_worker(env, tmp_path / "work")
            monkeypatch.setattr(config, "MIN_FREE_DISK_BYTES", 1 << 60)
            assert await worker.poll_once() is False
            assert worker.disk_paused
            row = await env.db.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                         {"i": jid})
            assert row["claimed_by"] is None and row["attempt"] == 0
            monkeypatch.setattr(config, "MIN_FREE_DISK_BYTES", 0)
            assert await drain(worker) == 1
            assert not worker.disk_paused
            return await env.db.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                          {"i": jid})
        finally:
            await _stop(env)

    assert run(go())["completed_at"] is not None


def test_workspace_sweep_reclaims_only_stale_workspaces(run, tmp_path):
    from vlog_tpu_torch.obs.metrics import runtime

    work = tmp_path / "work"
    old, fresh = work / "old-slug", work / "fresh-slug"
    for d in (old, fresh):
        (d / "out").mkdir(parents=True)
        (d / "out" / "seg.m4s").write_bytes(b"x" * 10)
    past = time.time() - 7 * 3600
    os.utime(old, (past, past))
    runs0 = runtime().gc_runs._value.get()

    async def go():
        env = await _start("vlog_tpu_torch", tmp_path / "srv")
        try:
            worker = port_worker(env, work)
            await worker._sweep_workspaces("test")
            await worker.client.aclose()
        finally:
            await _stop(env)

    run(go())
    assert not old.exists() and fresh.exists()
    assert runtime().gc_runs._value.get() == runs0 + 1


# --------------------------------------------------------------------------
# Cross-worker resume
# --------------------------------------------------------------------------

RESUME_FRAMES = 20          # two 10-frame dispatches at 10 fps, 1 s segments


@pytest.fixture
def resume_plan(monkeypatch, request):
    """Both packages: 1 s segments, one 10-frame chain per dispatch, a
    fast preemption poll; ``gop_mode`` from the test's parameter."""
    for pkg in ("vlog_tpu", "vlog_tpu_torch"):
        cfg = importlib.import_module(f"{pkg}.config")
        monkeypatch.setattr(cfg, "SEGMENT_DURATION_S", 1.0)
        monkeypatch.setattr(cfg, "TPU_FRAME_BATCH", 10)
        monkeypatch.setattr(cfg, "PREEMPTION_POLL_S", 0.05)
        monkeypatch.setattr(cfg, "GOP_MODE", request.param)
    return request.param


async def preempted(make, env: Env, work: Path) -> dict:
    """Run ``make``'s worker until the ``preempt.notice`` failpoint, armed
    at its first progress callback (dispatch 1 done), drains it with a 0 s
    grace: the attempt flushes its partial tree and is requeued as a
    refunded ``preempted`` failure. Returns the failure row."""
    pkg = "vlog_tpu_torch" if make is port_worker else "vlog_tpu"
    fp = importlib.import_module(f"{pkg}.utils.failpoints")
    worker = make(env, work, "transcode", drain_grace_s=0.0,
                  poll_interval_s=0.05)
    make_cb = worker._make_progress_cb

    def hooked(job_id, rung_names):
        cb = make_cb(job_id, rung_names)
        first = [True]

        def wrapped(done, total, msg):
            if first[0]:
                first[0] = False
                fp.arm("preempt.notice", count=1)
                deadline = time.monotonic() + 30
                while not worker._cancel.is_set() \
                        and time.monotonic() < deadline:
                    time.sleep(0.01)
            return cb(done, total, msg)
        return wrapped

    worker._make_progress_cb = hooked
    fp.arm("preempt.notice", count=0)       # the watcher exists, quiet
    try:
        await asyncio.wait_for(worker.run(), 120)
    finally:
        fp.reset()
        await worker.client.aclose()
    assert worker.drain.active
    return dict(await env.db.fetch_one(
        "SELECT * FROM job_failures ORDER BY id DESC LIMIT 1"))


RESUME_CASES = [  # (preempted by, resumed by, server, gop_mode)
    ("jax", "port", "vlog_tpu", "p"),
    ("port", "port", "vlog_tpu_torch", "p"),
    ("port", "jax", "vlog_tpu_torch", "p"),
    ("jax", "port", "vlog_tpu", "intra"),
    ("port", "jax", "vlog_tpu_torch", "intra"),
]


@pytest.mark.parametrize(
    "first,second,server,resume_plan", RESUME_CASES,
    ids=[f"{a}-then-{b}-{g}" for a, b, _, g in RESUME_CASES],
    indirect=["resume_plan"])
def test_cross_worker_resume(run, tmp_path, first, second, server,
                             resume_plan):
    """A preempted attempt's partial tree, resumed by another worker from
    the server, equals an uninterrupted run (I+P resumed by the
    reference: its own resume of its own partial tree, Queue C item 5)."""
    makers = {"jax": ref_worker, "port": port_worker}
    src = make_y4m(tmp_path / "r.y4m", n_frames=RESUME_FRAMES, width=128,
                   height=96, fps=10)
    oracle_by_own_resume = second == "jax" and resume_plan == "p"

    async def go():
        env = await _start(server, tmp_path / "srv")
        try:
            cut, cut_job = await enqueue(env, "Cut", src)
            failure = await preempted(makers[first], env, tmp_path / "w1")
            assert failure["job_id"] == cut_job
            assert failure["failure_class"] == "preempted"
            partial = _files(_tree(env, cut))
            assert any(k.endswith(".m4s") for k in partial), sorted(partial)
            assert "master.m3u8" not in partial
            assert await drain(makers[second](env, tmp_path / "w2",
                                              "transcode")) == 1
            whole, _ = await enqueue(env, "Whole", src)
            if oracle_by_own_resume:
                await preempted(makers[second], env, tmp_path / "w3")
            assert await drain(makers[second](env, tmp_path / "w4",
                                              "transcode")) == 1
            rows = [await env.db.fetch_one(
                "SELECT * FROM jobs WHERE video_id=:v AND kind='transcode'",
                {"v": v["id"]}) for v in (cut, whole)]
            spans = await env.db.fetch_all(
                "SELECT attributes FROM job_spans WHERE job_id=:j "
                "AND name='worker.transcode'", {"j": cut_job})
            return _tree(env, cut), _tree(env, whole), rows, spans
        finally:
            await _stop(env)

    cut, whole, rows, spans = run(go())
    for row in rows:
        assert row["completed_at"] is not None, row["error"]
        assert row["attempt"] == 1        # the preempted attempt refunded
    resumed = [json.loads(s["attributes"]).get("resumed_segments")
               for s in spans]
    assert any(n and n > 0 for n in resumed), resumed
    assert_trees_equal(whole, cut)


# --------------------------------------------------------------------------
# Transcription
# --------------------------------------------------------------------------

def test_transcription_over_http(run, tmp_path, tiny_model_dir,
                                 monkeypatch):  # slowlane-ok: tiny Whisper
    """A transcription job (a 3 s WAV, the random-weight tiny Whisper of
    the conftest, greedy): the reference's worker on the reference's
    server and the port's on the port's upload the same ``captions.vtt``
    and leave the same rows."""
    import numpy as np

    from vlog_tpu.asr import engine as jengine
    from vlog_tpu_torch.asr import engine as tengine
    from vlog_tpu_torch.media.audio import AudioData, write_wav

    for pkg in ("vlog_tpu", "vlog_tpu_torch"):
        cfg = importlib.import_module(f"{pkg}.config")
        monkeypatch.setattr(cfg, "WHISPER_BEAM", 1)
    t = np.arange(3 * 16000) / 16000
    pcm = 0.2 * np.sin(2 * np.pi * 220.0 * t) * (0.6 + 0.4 * np.sin(
        2 * np.pi * 3.5 * t))
    wav = tmp_path / "speech.wav"
    write_wav(wav, AudioData(pcm=pcm[None].astype(np.float32),
                             sample_rate=16000))
    out = {}
    for label, server, make in (("jax", "vlog_tpu", ref_worker),
                                ("port", "vlog_tpu_torch", port_worker)):
        async def go():
            env = await _start(server, tmp_path / label)
            try:
                video, jid = await enqueue(env, "Speech", wav,
                                           "transcription")
                worker = make(env, tmp_path / label / "work",
                              transcription_model_dir=str(tiny_model_dir))
                assert await drain(worker) == 1
                rows = {t: [dict(r) for r in await env.db.fetch_all(
                    f"SELECT * FROM {t} ORDER BY 1")]
                    for t in ("videos", "jobs", "transcriptions")}
                return (_tree(env, video) / "captions.vtt").read_bytes(), \
                    _normalize(rows, env.tmp)
            finally:
                await _stop(env)
        try:
            out[label] = run(go())
        finally:
            jengine.reset_engine()
            tengine.reset_engine()
    vtt, rows = out["port"]
    assert vtt.startswith(b"WEBVTT") and vtt == out["jax"][0]
    assert rows["jobs"][0]["error"] is None
    assert rows["transcriptions"][0]["status"] == "completed"
    assert rows == out["jax"][1]


def test_run_gc_matches_the_reference(run, tmp_path):
    """``storage.gc.run_gc`` of both packages on identical trees and rows:
    a stale temp, an orphan tree, a soft-deleted video's tree past its
    retention, a live claim's tree (kept), a stale workspace."""
    out = {}
    for pkg in ("vlog_tpu", "vlog_tpu_torch"):
        gc = importlib.import_module(f"{pkg}.storage.gc")
        root = tmp_path / pkg
        vdir, wdir = root / "videos", root / "work"
        old = time.time() - 30 * 86400

        async def go():
            env = await _start(pkg, root / "srv")
            try:
                live, _ = await enqueue(env, "Live", make_y4m(
                    root / "l.y4m", n_frames=2, width=64, height=48))
                gone, _ = await enqueue(env, "Gone", make_y4m(
                    root / "g.y4m", n_frames=2, width=64, height=48),
                    "sprite")
                await env.db.execute(
                    "UPDATE videos SET deleted_at=:t WHERE id=:i",
                    {"t": old, "i": gone["id"]})
                await env.mod["claims"].claim_job(env.db, "w")
                for rel in (f"{live['slug']}/a.m4s.part",
                            f"{gone['slug']}/360p/seg.m4s",
                            "orphan/360p/seg.m4s", "stray.part"):
                    (vdir / rel).parent.mkdir(parents=True, exist_ok=True)
                    (vdir / rel).write_bytes(b"x" * 7)
                (wdir / "old-ws").mkdir(parents=True)
                for p in [*vdir.rglob("*"), wdir / "old-ws"]:
                    os.utime(p, (old, old))
                report = await gc.run_gc(env.db, video_dir=vdir,
                                         work_dirs=(wdir,))
                return report.to_dict()
            finally:
                await _stop(env)
        rep = run(go())
        out[pkg] = sorted((Path(e["path"]).relative_to(root).as_posix(),
                           e["kind"], e["bytes"]) for e in rep["removed"])
        out[pkg + ":kept"] = [Path(k).relative_to(root).as_posix()
                              for k in rep["kept_live"]]
    assert out["vlog_tpu_torch"] == out["vlog_tpu"]
    assert out["vlog_tpu_torch:kept"] == out["vlog_tpu:kept"] \
        == ["videos/live"]
    assert out["vlog_tpu"] == [
        ("videos/gone", "deleted_tree", 7), ("videos/orphan", "orphan_tree", 7),
        ("videos/stray.part", "part_file", 7), ("work/old-ws", "workspace", 0)]


def test_remote_worker_requires_cuda_by_default(tmp_path):
    import torch

    from vlog_tpu_torch.worker.remote import RemoteWorker, WorkerAPIClient

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RemoteWorker(WorkerAPIClient("http://127.0.0.1:1", "k"),
                     name="w", work_dir=tmp_path)


def test_preemption_url_answering_200_fires_the_notice(run):
    """The port's watcher polls the metadata URL with aiohttp: 200 is
    the notice, any other answer or no answer is not."""
    from aiohttp import web
    from aiohttp.test_utils import TestServer

    from vlog_tpu_torch.worker.drain import PreemptionWatcher

    async def go():
        async def evict(request):
            return web.Response(text="now")

        async def quiet(request):
            return web.Response(status=404)

        app = web.Application()
        app.router.add_get("/evict", evict)
        app.router.add_get("/quiet", quiet)
        server = TestServer(app)
        await server.start_server()
        try:
            got = {}
            for route in ("evict", "quiet"):
                w = PreemptionWatcher(url=str(server.make_url(f"/{route}")))
                got[route] = await w.check()
                await w.aclose()
            dead = PreemptionWatcher(url="http://127.0.0.1:9/none")
            got["dead"] = await dead.check()
            await dead.aclose()
            stop = asyncio.Event()
            fired = []

            async def on_notice(reason):
                fired.append(reason)

            w = PreemptionWatcher(url=str(server.make_url("/evict")),
                                  poll_s=0.1)
            await asyncio.wait_for(w.watch(stop, on_notice), 10)
            return got, fired
        finally:
            await server.close()

    got, fired = run(go())
    assert got["evict"].startswith("preemption notice URL answered 200")
    assert got["quiet"] is None and got["dead"] is None
    assert len(fired) == 1 and "answered 200" in fired[0]
