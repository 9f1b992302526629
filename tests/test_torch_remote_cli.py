"""The port's remote-worker entry point, ``python -m
vlog_tpu_torch.worker.remote``, and the Worker API server's, ``python -m
vlog_tpu_torch.api.worker_api``.

- Both in subprocesses on a temporary sqlite file: the worker (``_amain``
  on the CPU through ``python -c``, since the CLI has no device option)
  registers itself (dev mode, no admin secret), runs a sprite job with
  no backend, answers ``/health`` and ``/ready`` on its health port;
  SIGTERM: the drain and exit code 0.
- ``_amain(args, device="cpu")`` in-process against the port's server:
  the ``restart`` verb ends it with ``mgmt.RESTART_EXIT_CODE``.
- ``main`` always runs on CUDA (``--help`` lists no device option): on a
  machine with no CUDA it raises before it touches the network.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import socket
import sqlite3
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from tests.fixtures.media import make_y4m
from vlog_tpu_torch.db import Database, create_all
from vlog_tpu_torch.enums import JobKind
from vlog_tpu_torch.jobs import claims, commands as cmds, videos as vids
from vlog_tpu_torch.worker import remote

ROOT = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def seed(db_url: str, src: Path, kind: JobKind) -> int:
    db = Database(db_url)
    await db.connect()
    await create_all(db)
    try:
        video = await vids.create_video(db, "CLI", source_path=str(src))
        return await claims.enqueue_job(db, video["id"], kind)
    finally:
        await db.disconnect()


def _wait_http(url: str, timeout: float = 60.0) -> int:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with urllib.request.urlopen(url, timeout=5) as r:
                return r.status
        except OSError:
            time.sleep(0.1)
    raise AssertionError(f"{url} never answered")


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


def _stop(proc: subprocess.Popen) -> str:
    if proc.poll() is None:
        proc.kill()
    return proc.communicate()[0]


# ``_amain`` on the CPU in a child process: ``main`` without its device
# (the CLI has no option for it), sprites only, no backend.
_CHILD = """
import argparse, asyncio, logging, sys
from vlog_tpu_torch.worker.remote import _amain
logging.basicConfig(level=logging.INFO)
asyncio.run(_amain(argparse.Namespace(
    api=sys.argv[1], key="", admin_secret="", name="cli-rw",
    work_dir=sys.argv[2], accelerator="tpu", kinds="sprite", backend="",
    no_backend=True, whisper_dir=None), device="cpu"))
"""


def test_server_and_worker_clis_run_a_job_and_drain(run, tmp_path):
    db_path = tmp_path / "cli.db"
    db_url = f"sqlite:///{db_path}"
    src = make_y4m(tmp_path / "src.y4m", n_frames=10, width=128, height=96,
                   fps=24)
    job_id = run(seed(db_url, src, JobKind.SPRITE))
    api_port, health_port = free_port(), free_port()
    env = {**os.environ, "VLOG_BASE_DIR": str(tmp_path / "data"),
           "VLOG_DATABASE_URL": db_url,
           "VLOG_WORKER_API_PORT": str(api_port),
           "VLOG_WORKER_POLL_INTERVAL": "0.1",
           "VLOG_HEARTBEAT_INTERVAL": "5",
           "VLOG_WORKER_HEALTH_PORT": str(health_port),
           "PYTHONPATH": str(ROOT)}
    env.pop("VLOG_ADMIN_SECRET", None)
    server = subprocess.Popen(
        [sys.executable, "-m", "vlog_tpu_torch.api.worker_api"], cwd=tmp_path,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    worker = None
    try:
        _wait_http(f"http://127.0.0.1:{api_port}/healthz")
        worker = subprocess.Popen(
            [sys.executable, "-c", _CHILD, f"http://127.0.0.1:{api_port}",
             str(tmp_path / "work")],
            cwd=tmp_path, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        _poll(db_path, f"SELECT completed_at FROM jobs WHERE id={job_id}")
        health = {route: _wait_http(f"http://127.0.0.1:{health_port}{route}")
                  for route in ("/health", "/ready")}
        worker.send_signal(signal.SIGTERM)
        out, _ = worker.communicate(timeout=60)
    finally:
        if worker is not None:
            _stop(worker)
        server_out = _stop(server)
    assert worker.returncode == 0, out
    assert "entering drain (SIGTERM)" in out
    assert health == {"/health": 200, "/ready": 200}
    assert "worker API listening" in server_out
    with sqlite3.connect(db_path) as con:
        kind, key_rows = con.execute(
            "SELECT kind, (SELECT COUNT(*) FROM worker_api_keys "
            "WHERE worker_name='cli-rw') FROM workers "
            "WHERE name='cli-rw'").fetchone()
    assert (kind, key_rows) == ("remote", 1)
    assert (tmp_path / "data" / "videos" / "cli" / "sprites"
            / "sprites.vtt").exists()


def test_amain_restart_verb_exits_with_the_restart_code(run, tmp_path,
                                                        monkeypatch):
    from aiohttp.test_utils import TestServer

    from vlog_tpu_torch.api.worker_api import build_worker_app
    from vlog_tpu_torch.worker.mgmt import RESTART_EXIT_CODE

    async def go():
        db = Database(f"sqlite:///{tmp_path / 'r.db'}")
        await db.connect()
        await create_all(db)
        server = TestServer(build_worker_app(db, video_dir=tmp_path / "v"))
        await server.start_server()

        async def restart_once_registered():
            while await db.fetch_one(
                    "SELECT 1 FROM workers WHERE name='amain-rw'") is None:
                await asyncio.sleep(0.05)
            await cmds.send_command(db, "amain-rw", "restart")

        helper = asyncio.create_task(restart_once_registered())
        try:
            ns = argparse.Namespace(
                api=str(server.make_url("")).rstrip("/"), key="",
                admin_secret="", name="amain-rw",
                work_dir=str(tmp_path / "work"), accelerator="tpu",
                kinds="sprite", backend="", no_backend=True,
                whisper_dir=None)
            # awaited here, not in a task: SystemExit reaches the caller
            async with asyncio.timeout(60):
                await remote._amain(ns, device="cpu")
        finally:
            helper.cancel()
            await asyncio.gather(helper, return_exceptions=True)
            await server.close()
            await db.disconnect()

    from vlog_tpu_torch import config

    monkeypatch.setattr(config, "HEARTBEAT_INTERVAL_S", 0.05)
    with pytest.raises(SystemExit) as exc:
        run(go())
    assert exc.value.code == RESTART_EXIT_CODE


def test_cli_has_no_device_option(capsys):
    with pytest.raises(SystemExit) as exc:
        remote.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "--no-backend" in out and "--device" not in out


@pytest.mark.parametrize("extra", [[], ["--no-backend"]])
def test_main_refuses_cuda_without_cuda(extra):
    if torch.cuda.is_available():
        pytest.skip("needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        # port 9 (discard): the device check comes before any request
        remote.main(["--api", "http://127.0.0.1:9", "--key",
                     "vlwk_0123abcd" + "e" * 64] + extra)
