"""The port's worker entry point: ``python -m vlog_tpu_torch.worker.daemon``.

- ``_amain(args, device="cpu")`` in-process on a temporary sqlite file
  with the health server on an ephemeral port (``/health``, ``/ready``,
  ``/metrics``): sprite jobs with ``--no-backend``, and a transcode with
  its sprite job through a CPU backend taken from the registry
  (``--backend torch``); the ``stop`` command ends it. With a backend,
  ``_amain`` runs the process-wide scheduler (here one over the CPU in
  its place): a ``device.fault`` attempt quarantines the device, and
  the probe reinstates it or, failing with no slot left, the process
  exits with code 64.
- In a subprocess (``_amain`` through ``python -c``): a job, then
  SIGTERM: the drain, exit code 0 and the worker row offline; the
  ``restart`` verb: exit code 64.
- Without CUDA the entry point raises: it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import socket
import sqlite3
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from tests.fixtures.media import make_y4m
from tests.test_torch_backend import one_torch_thread  # noqa: F401
from vlog_tpu_torch import config
from vlog_tpu_torch.db import Database, create_all
from vlog_tpu_torch.enums import JobKind
from vlog_tpu_torch.jobs import claims, commands as cmds, videos as vids
from vlog_tpu_torch.parallel import scheduler as sched_mod
from vlog_tpu_torch.parallel.scheduler import MeshScheduler
from vlog_tpu_torch.utils import failpoints
from vlog_tpu_torch.worker import daemon as daemon_mod

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def args_for(db_url: str, **kw) -> argparse.Namespace:
    base = dict(name="cli-w", db=db_url, accelerator="tpu",
                kinds="transcode,reencode,sprite,transcription", backend="",
                no_backend=False, whisper_dir=None)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.fixture
def cpu_scheduler(monkeypatch):
    """The process-wide scheduler ``_amain`` takes, over the CPU (on the
    card, ``get_scheduler()`` builds it over the CUDA devices)."""
    sched = MeshScheduler(devices=["cpu"], slots=1)
    monkeypatch.setattr(sched_mod, "_scheduler", sched)
    return sched


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """The storage tree under tmp_path (ensure_dirs creates it)."""
    monkeypatch.setattr(config, "BASE_DIR", tmp_path / "data")
    for name in ("UPLOAD_DIR", "VIDEO_DIR", "TMP_DIR"):
        monkeypatch.setattr(config, name, tmp_path / "data" / name.lower())
    monkeypatch.setattr(config, "HEARTBEAT_INTERVAL_S", 0.05)
    monkeypatch.setattr(config, "WORKER_POLL_INTERVAL_S", 0.05)
    return tmp_path


async def seed(db_url: str, src: Path, kind: JobKind) -> int:
    db = Database(db_url)
    await db.connect()
    await create_all(db)
    video = await vids.create_video(db, "CLI", source_path=str(src),
                                    size_bytes=src.stat().st_size)
    await db.execute("UPDATE videos SET duration_s=0.4 WHERE id=:i",
                     {"i": video["id"]})
    job_id = await claims.enqueue_job(db, video["id"], kind)
    await db.disconnect()
    return job_id


async def get(port: int, path: str) -> tuple[int, str]:
    import aiohttp

    async with aiohttp.ClientSession() as s:
        async with s.get(f"http://127.0.0.1:{port}{path}") as r:
            return r.status, await r.text()


async def wait_health(port: int, task) -> None:
    for _ in range(500):
        if task.done():
            task.result()
        try:
            status, _ = await get(port, "/health")
            if status == 200:
                return
        except OSError:
            pass
        await asyncio.sleep(0.02)
    raise AssertionError("the health server never answered")


async def wait_jobs_done(db, n: int, timeout: float = 120.0) -> list[dict]:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rows = await db.fetch_all("SELECT * FROM jobs ORDER BY id")
        if len(rows) >= n and all(r["completed_at"] or r["failed_at"]
                                  for r in rows):
            return rows
        await asyncio.sleep(0.05)
    raise AssertionError(f"jobs not done: {rows}")


@pytest.mark.parametrize("mode", ["no_backend_sprites",
                                  "registry_cpu_backend"])
def test_amain_runs_jobs_behind_the_health_server(run, dirs, monkeypatch,
                                                  cpu_scheduler, mode):
    port = free_port()
    monkeypatch.setenv("VLOG_WORKER_HEALTH_PORT", str(port))
    db_url = f"sqlite:///{dirs / 'cli.db'}"
    src = make_y4m(dirs / "src.y4m", n_frames=10, width=128, height=96,
                   fps=24)
    if mode == "no_backend_sprites":
        kind, ns, n_jobs = JobKind.SPRITE, args_for(
            db_url, no_backend=True, kinds="sprite"), 1
    else:
        kind, ns, n_jobs = JobKind.TRANSCODE, args_for(
            db_url, backend="torch"), 2
    run(seed(db_url, src, kind))

    async def go():
        task = asyncio.create_task(daemon_mod._amain(ns, device="cpu"))
        await wait_health(port, task)
        status, body = await get(port, "/ready")
        assert status == 200 and json.loads(body)["ready"] is True
        db = Database(db_url)
        await db.connect()
        try:
            rows = await wait_jobs_done(db, n_jobs)
            assert all(r["completed_at"] for r in rows), rows
            status, metrics = await get(port, "/metrics")
            assert status == 200
            from vlog_tpu_torch.obs.metrics import HAVE_PROMETHEUS

            if HAVE_PROMETHEUS:
                assert 'vlog_worker_jobs_total{event="completed"}' in metrics
            worker = await db.fetch_one(
                "SELECT * FROM workers WHERE name='cli-w'")
            caps = json.loads(worker["capabilities"])
            if mode == "registry_cpu_backend":
                assert caps["backend"] == "torch"
                assert caps["device_kind"] == "cpu"
                spans = await db.fetch_all(
                    "SELECT attributes FROM job_spans "
                    "WHERE name='worker.transcode'")
                assert [json.loads(a["attributes"])["mesh.width"]
                        for a in spans] == [1]    # ran on a slot lease
            else:
                assert caps == {}
            await cmds.send_command(db, "cli-w", "stop")
            await asyncio.wait_for(task, 30.0)
            worker = await db.fetch_one(
                "SELECT * FROM workers WHERE name='cli-w'")
            assert worker["status"] == "offline"
        finally:
            await db.disconnect()

    run(go())
    sheets = list((dirs / "data" / "video_dir").rglob("sprite_01.jpg"))
    assert len(sheets) == 1


@pytest.mark.parametrize("probe_passes", [True, False],
                         ids=["probe_reinstates", "sticky_fault_restarts"])
def test_amain_device_fault_quarantines_the_device(run, dirs, monkeypatch,
                                                   cpu_scheduler,
                                                   probe_passes):
    """The entry point's configuration: a ``device.fault`` attempt is
    refunded as ``device_fault`` and quarantines the scheduler's device.
    A passing probe reinstates it and the retry completes; a failing one
    with no slot left ends ``_amain`` with exit code 64 (ROADMAP Queue C
    item 15)."""
    monkeypatch.setenv("VLOG_WORKER_HEALTH_PORT", str(free_port()))
    monkeypatch.setattr(config, "DEVICE_PROBE_INTERVAL_S", 0.05)
    if not probe_passes:
        monkeypatch.setattr(sched_mod, "_default_probe", lambda d: False)
    quarantined = []
    report = cpu_scheduler.report_device_fault

    def spy_report(lease, **kw):
        newly = report(lease, **kw)
        quarantined.append((newly, cpu_scheduler.snapshot()["slots"]))
        return newly

    cpu_scheduler.report_device_fault = spy_report
    db_url = f"sqlite:///{dirs / 'fault.db'}"
    src = make_y4m(dirs / "src.y4m", n_frames=10, width=128, height=96,
                   fps=24)
    job_id = run(seed(db_url, src, JobKind.TRANSCODE))
    ns = args_for(db_url, backend="torch", kinds="transcode")
    failpoints.arm("device.fault", count=1)

    async def read():
        db = Database(db_url)
        await db.connect()
        try:
            return (await db.fetch_one("SELECT * FROM jobs WHERE id=:i",
                                       {"i": job_id}),
                    await claims.get_failure_history(db, job_id))
        finally:
            await db.disconnect()

    async def until_done():
        task = asyncio.create_task(daemon_mod._amain(ns, device="cpu"))
        deadline = time.monotonic() + 120
        while (await read())[0]["completed_at"] is None:
            assert time.monotonic() < deadline and not task.done()
            await asyncio.sleep(0.05)
        db = Database(db_url)
        await db.connect()
        await cmds.send_command(db, "cli-w", "stop")
        await db.disconnect()
        await asyncio.wait_for(task, 30.0)

    try:
        if probe_passes:
            run(until_done())
        else:
            with pytest.raises(SystemExit) as exc:   # stops by itself
                run(asyncio.wait_for(daemon_mod._amain(ns, device="cpu"),
                                     60.0))
            assert exc.value.code == 64
    finally:
        failpoints.reset()
    job, hist = run(read())
    assert [h["failure_class"] for h in hist] == ["device_fault"]
    assert quarantined == [(("cpu",), 0)]
    assert job["failed_at"] is None
    if probe_passes:
        assert job["completed_at"] is not None and job["attempt"] == 1
        assert cpu_scheduler.quarantined_count() == 0
    else:
        assert job["completed_at"] is None and job["attempt"] == 0
        assert cpu_scheduler.snapshot()["slots"] == 0


@pytest.mark.parametrize("extra", [[], ["--no-backend"],
                                   ["--backend", "torch"]])
def test_main_refuses_cuda_without_cuda(dirs, extra):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError):
        daemon_mod.main(["--name", "nocuda", "--db",
                         f"sqlite:///{dirs / 'n.db'}"] + extra)


# ``_amain`` on the CPU in a child process: ``main`` without its device
# (the CLI has no option for it), sprites only, no backend.
_CHILD = """
import argparse, asyncio, logging, sys
from vlog_tpu_torch.worker.daemon import _amain
logging.basicConfig(level=logging.INFO)
asyncio.run(_amain(argparse.Namespace(
    name="sub-w", db=sys.argv[1], accelerator="tpu", kinds="sprite",
    backend="", no_backend=True, whisper_dir=None), device="cpu"))
"""


def _spawn(tmp_path: Path, db_url: str) -> subprocess.Popen:
    env = {**os.environ, "VLOG_BASE_DIR": str(tmp_path / "data"),
           "VLOG_WORKER_POLL_INTERVAL": "0.1",
           "VLOG_HEARTBEAT_INTERVAL": "5",
           "PYTHONPATH": str(ROOT)}
    env.pop("VLOG_WORKER_HEALTH_PORT", None)
    return subprocess.Popen(
        [sys.executable, "-c", _CHILD, db_url],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _poll(db_path: Path, sql: str, timeout: float = 90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with sqlite3.connect(db_path) as con:
                row = con.execute(sql).fetchone()
            if row and row[0]:
                return row
        except sqlite3.OperationalError:
            pass
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for: {sql}")


def test_sigterm_drains_and_exits_zero(run, tmp_path):
    db_path = tmp_path / "sub.db"
    db_url = f"sqlite:///{db_path}"
    src = make_y4m(tmp_path / "src.y4m", n_frames=10, width=128, height=96,
                   fps=24)
    job_id = run(seed(db_url, src, JobKind.SPRITE))
    proc = _spawn(tmp_path, db_url)
    try:
        _poll(db_path, f"SELECT completed_at FROM jobs WHERE id={job_id}")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "entering drain (SIGTERM)" in out
    with sqlite3.connect(db_path) as con:
        status = con.execute(
            "SELECT status FROM workers WHERE name='sub-w'").fetchone()
    assert status == ("offline",)


def test_restart_verb_exits_64(run, tmp_path):
    db_path = tmp_path / "sub.db"
    db_url = f"sqlite:///{db_path}"
    src = make_y4m(tmp_path / "src.y4m", n_frames=4, width=64, height=48,
                   fps=24)
    run(seed(db_url, src, JobKind.SPRITE))
    proc = _spawn(tmp_path, db_url)
    try:
        _poll(db_path, "SELECT last_heartbeat_at FROM workers "
                       "WHERE name='sub-w'")

        async def send():
            db = Database(db_url)
            await db.connect()
            await cmds.send_command(db, "sub-w", "restart")
            await db.disconnect()

        run(send())
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 64, out
    assert "remote restart command received" in out
