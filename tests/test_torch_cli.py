"""The port's console client (``vlog_tpu_torch/cli/main.py``) against the
JAX package's (``vlog_tpu/cli/main.py``).

- Both parsers print the same ``--help``, top level and for every
  subcommand.
- The port's quick start on loopback, on the CPU: the port's admin and
  public apps and a ``WorkerDaemon(device="cpu")`` on one sqlite file,
  in a background event loop. ``upload --wait`` through the port's client
  reaches ``ready`` and the public app serves the master playlist; then
  ``list``, ``status``, ``workers``, ``retranscode``, ``settings`` and
  ``webhooks``. Every read-only command prints the same lines through
  either package's client, and an error (an unknown video) exits alike.
- ``serve`` and ``worker`` launch the port's services, never the
  reference's.
- ``VLOG_ADMIN_URL``, ``VLOG_PUBLIC_URL`` and ``VLOG_ADMIN_SECRET`` are
  read when the module is imported, as in the reference.
"""

from __future__ import annotations

import asyncio
import importlib
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest

from tests.fixtures.media import make_y4m

ROOT = Path(__file__).resolve().parent.parent
SUBCOMMANDS = ("upload", "list", "status", "delete", "restore",
               "retranscode", "manifests-regenerate", "download", "workers",
               "worker-revoke", "settings", "webhooks", "serve", "worker")


def _clis():
    return (importlib.import_module("vlog_tpu.cli.main"),
            importlib.import_module("vlog_tpu_torch.cli.main"))


def _help(cli, argv, capsys) -> str:
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("sub", ("",) + SUBCOMMANDS)
def test_help_is_the_reference_help(sub, capsys):
    argv = [sub, "--help"] if sub else ["--help"]
    jax_cli, port_cli = _clis()
    want = _help(jax_cli, argv, capsys)
    got = _help(port_cli, argv, capsys)
    assert got == want
    assert "usage: vlog-tpu" in got


# --------------------------------------------------------------------------
# the quick start on loopback
# --------------------------------------------------------------------------

@pytest.fixture
def stack(tmp_path):
    """The port's admin app (``device="cpu"``), public app and CPU worker
    daemon on one sqlite file, in a background thread's event loop."""
    import torch
    from aiohttp import web

    from vlog_tpu_torch.api.admin_api import build_admin_app
    from vlog_tpu_torch.api.public_api import build_public_app
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.db import Database, create_all
    from vlog_tpu_torch.enums import JobKind
    from vlog_tpu_torch.worker.daemon import WorkerDaemon

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def call(coro, timeout: float = 60.0):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(timeout)

    db = Database(f"sqlite:///{tmp_path / 'vlog.db'}")
    out = {"db": db, "videos": tmp_path / "videos", "runners": []}

    async def start():
        await db.connect()
        await create_all(db)
        for name, app in (
                ("admin", build_admin_app(
                    db, upload_dir=tmp_path / "uploads",
                    video_dir=tmp_path / "videos", device="cpu")),
                ("public", build_public_app(db,
                                            video_dir=tmp_path / "videos"))):
            runner = web.AppRunner(app)
            await runner.setup()
            await web.TCPSite(runner, "127.0.0.1", 0).start()
            out["runners"].append(runner)
            out[name] = "http://127.0.0.1:%d" % runner.addresses[0][1]
        daemon = WorkerDaemon(
            db, name="cli-worker", device="cpu",
            backend=TorchBackend(device="cpu"), video_dir=tmp_path / "videos",
            kinds=(JobKind.TRANSCODE,), poll_interval_s=0.2,
            progress_min_interval_s=0.0)
        out["daemon"] = daemon
        out["task"] = asyncio.create_task(daemon.run())

    async def stop():
        out["daemon"].request_stop()
        await asyncio.wait_for(out["task"], 60)
        for runner in out["runners"]:
            await runner.cleanup()
        await db.disconnect()

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    call(start())
    try:
        yield out
    finally:
        try:
            call(stop())
        finally:
            torch.set_num_threads(threads)
            loop.call_soon_threadsafe(loop.stop)
            thread.join(timeout=10)
            loop.close()


def _run(cli, argv, capsys) -> tuple[str, str, object]:
    code = None
    try:
        cli.main(argv)
    except SystemExit as exc:
        code = exc.code
    got = capsys.readouterr()
    return got.out, got.err, code


def test_quick_start_on_loopback(stack, tmp_path, monkeypatch, capsys):
    jax_cli, port_cli = _clis()
    for cli in (jax_cli, port_cli):
        monkeypatch.setattr(cli, "ADMIN_URL", stack["admin"])
        monkeypatch.setattr(cli, "PUBLIC_URL", stack["public"])
        monkeypatch.setattr(cli, "ADMIN_SECRET", "")
    src = make_y4m(tmp_path / "movie.y4m", n_frames=24, width=128,
                   height=96, fps=24, seed=2)
    out, err, code = _run(port_cli, ["upload", str(src), "--wait",
                                     "--description", "from the CLI"],
                          capsys)
    assert code is None, err
    lines = out.splitlines()
    assert lines[0] == "uploaded: video 1 slug=movie job=1"
    assert lines[-1].startswith("status=ready progress=100.0%")
    with urllib.request.urlopen(
            f"{stack['public']}/videos/movie/master.m3u8", timeout=30) as r:
        master = r.read().decode()
    assert master.startswith("#EXTM3U") and "avc1" in master
    assert (stack["videos"] / "movie" / "master.m3u8").read_text() == master

    # every read-only command prints alike through both clients
    for argv in (["list"], ["list", "--status", "ready", "--limit", "5"],
                 ["status", "1"], ["workers"], ["settings", "list"],
                 ["webhooks", "list"], ["status", "999"]):
        want = _run(jax_cli, argv, capsys)
        got = _run(port_cli, argv, capsys)
        assert got == want, argv
    assert "1 ready" in _run(port_cli, ["list"], capsys)[0].replace("  ", " ")
    assert _run(port_cli, ["status", "999"], capsys)[1:] == (
        "error 404: no such video\n", 1)

    # the mutating commands
    assert _run(port_cli, ["settings", "set", "site.title", '"Mine"'],
                capsys)[0] == "ok\n"
    assert _run(port_cli, ["settings", "list"], capsys)[0] == \
        "site.title = 'Mine'\n"
    assert _run(port_cli, ["settings", "unset", "site.title"],
                capsys)[0] == "ok\n"
    out = _run(port_cli, ["webhooks", "add", "https://hooks.example.invalid/x",
                          "--events", "video.ready"], capsys)[0]
    assert out == "webhook 1\n"
    assert _run(port_cli, ["webhooks", "list"], capsys)[0] == \
        "   1 [on] https://hooks.example.invalid/x events=video.ready\n"
    assert _run(port_cli, ["webhooks", "rm", "--webhook-id", "1"],
                capsys)[0] == "ok\n"
    assert _run(port_cli, ["retranscode", "1", "--force"], capsys)[0] \
        .startswith("enqueued job ")
    assert _run(port_cli, ["webhooks", "rm"], capsys)[2] == \
        "webhooks rm requires --webhook-id"


# --------------------------------------------------------------------------
# launchers and the environment
# --------------------------------------------------------------------------

@pytest.mark.parametrize("argv,module", [
    (["serve", "worker-api"], "vlog_tpu_torch.api.worker_api"),
    (["serve", "admin"], "vlog_tpu_torch.api.admin_api"),
    (["serve", "public"], "vlog_tpu_torch.api.public_api"),
    (["worker", "local", "--name", "w"], "vlog_tpu_torch.worker.daemon"),
    (["worker", "remote", "--key", "k"], "vlog_tpu_torch.worker.remote"),
])
def test_launchers_start_the_port(argv, module, monkeypatch):
    calls = []
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, "main", lambda *a: calls.append(a))
    _, port_cli = _clis()
    port_cli.main(argv)
    assert calls == ([(argv[2:],)] if argv[0] == "worker" else [()])


def test_environment_is_read_at_import():
    script = (
        "import sys; sys.path.insert(0, %r)\n"
        "from vlog_tpu_torch.cli import main as m\n"
        "print(m.ADMIN_URL, m.PUBLIC_URL, m.ADMIN_SECRET)\n"
        "print(sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('vlog_tpu', 'httpx', 'jax')))\n"
        % str(ROOT))
    env = {"VLOG_ADMIN_URL": "http://admin.invalid:1",
           "VLOG_PUBLIC_URL": "http://public.invalid:2",
           "VLOG_ADMIN_SECRET": "shh", "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines() == [
        "http://admin.invalid:1 http://public.invalid:2 shh", "[]"]
