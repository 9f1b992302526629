"""Shared management-command verbs for local and remote workers (port of
``vlog_tpu/worker/mgmt.py``; the device summary reads torch's CUDA state
instead of jax's devices).

Reference parity: worker/command_listener.py:244-448 — beyond
ping/stats/stop, operators can pull a worker's recent logs and
process/device metrics over the command channel (surfaced at
admin.py:5164-5290), and ask for a restart. Both worker flavors
(worker/daemon.py, worker/remote.py) delegate these verbs here so the
two planes can never drift.

``restart`` is cooperative: the worker stops cleanly and exits with
:data:`RESTART_EXIT_CODE`; the supervisor (systemd ``Restart=always``
unit / k8s restartPolicy) brings it back with the current image. The
reference's in-place ``update`` verb (git pull + re-exec) has no analog
in image-based deploys and is reported as unsupported.
"""

from __future__ import annotations

import os
import resource
import time

from vlog_tpu_torch.utils.logring import install_ring

RESTART_EXIT_CODE = 64     # systemd RestartForceExitStatus target

_started_at = time.time()


def get_logs(args: dict) -> dict:
    """Tail the in-process log ring (utils/logring.py)."""
    ring = install_ring()
    n = max(1, min(int(args.get("lines", 100) or 100), 2000))
    level = args.get("level")
    lines = ring.tail(n, level=level)
    return {"lines": lines, "count": len(lines),
            "level": level or "all"}


def _proc_status() -> dict:
    """RSS/threads/fds from /proc (no psutil in the image)."""
    out: dict = {}
    try:
        with open("/proc/self/status") as fp:
            for line in fp:
                if line.startswith("VmRSS:"):
                    out["rss_mb"] = round(
                        int(line.split()[1]) / 1024.0, 1)
                elif line.startswith("Threads:"):
                    out["threads"] = int(line.split()[1])
    except OSError:
        pass
    try:
        out["open_fds"] = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    return out


def _device_info() -> dict:
    """Accelerator summary WITHOUT initializing CUDA (a metrics probe must
    never pay — or hang on — device init; report what the process
    already knows): ``{"initialized": False}`` until this process has
    initialized CUDA, then the platform, the device count, and the bytes
    the caching allocator holds in tensors against the card's total."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return {"initialized": False}
    try:
        dev = torch.cuda.current_device()
        _free, total = torch.cuda.mem_get_info(dev)
        return {"initialized": True, "platform": "cuda",
                "device_count": torch.cuda.device_count(),
                "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
                "bytes_limit": int(total)}
    except Exception:   # noqa: BLE001 — metrics are best-effort
        return {"initialized": True, "error": "device query failed"}


def profile(args: dict) -> dict:
    """Drive an on-demand device-profiling session (obs/profiler.py).

    ``action`` selects start (default) / stop / status. Start refuses
    on CUDA until this process has initialized it — the same
    never-pay-for-init rule as :func:`_device_info` — and is
    duration-bounded + exclusive, so a profile command can never leave
    tracing on or stack sessions.
    """
    from vlog_tpu_torch.obs.profiler import profiler

    action = str(args.get("action", "start") or "start").lower()
    prof = profiler()
    if action == "stop":
        return prof.stop()
    if action == "status":
        return prof.status()
    if action != "start":
        return {"error": f"unknown profile action: {action}"}
    return prof.start(duration_s=args.get("duration_s"),
                      label=str(args.get("label", "") or ""))


def get_metrics(extra: dict | None = None) -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {
        "uptime_s": round(time.time() - _started_at, 1),
        "cpu_user_s": round(ru.ru_utime, 2),
        "cpu_system_s": round(ru.ru_stime, 2),
        **_proc_status(),
        "device": _device_info(),
    }
    if extra:
        out.update(extra)
    return out
