"""The configuration the ported slice reads.

Same ``VLOG_*`` names and defaults as the JAX package's config (ladder,
GOP structure, entropy, deblocking, search radius, batch and pipeline
depth, sprite sheets, transcription, the device runtime), so one
environment configures both. Only what the port's H.264 paths (I+P or
intra-only, CMAF or MPEG-TS), its HEVC path, its pipeline, its sprite
worker, its transcription worker, its device runtime and its worker
daemon with the job plane under it read is here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path


class ConfigError(ValueError):
    """Raised when an environment override fails validation."""


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _env_int(name: str, default: int, *, lo: int | None = None,
             hi: int | None = None) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        val = int(raw)
    except ValueError as exc:
        raise ConfigError(f"{name}={raw!r} is not an integer") from exc
    if lo is not None and val < lo:
        raise ConfigError(f"{name}={val} below minimum {lo}")
    if hi is not None and val > hi:
        raise ConfigError(f"{name}={val} above maximum {hi}")
    return val


def _env_float(name: str, default: float, *, lo: float | None = None,
               hi: float | None = None) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        val = float(raw)
    except ValueError as exc:
        raise ConfigError(f"{name}={raw!r} is not a number") from exc
    if lo is not None and val < lo:
        raise ConfigError(f"{name}={val} below minimum {lo}")
    if hi is not None and val > hi:
        raise ConfigError(f"{name}={val} above maximum {hi}")
    return val


def _env_path(name: str, default: str) -> Path:
    return Path(os.environ.get(name, default)).expanduser()


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    low = raw.strip().lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise ConfigError(f"{name}={raw!r} is not a boolean")


# Storage layout and the database (the worker daemon's defaults).
BASE_DIR: Path = _env_path("VLOG_BASE_DIR", "./data")
UPLOAD_DIR: Path = _env_path("VLOG_UPLOAD_DIR", str(BASE_DIR / "uploads"))
VIDEO_DIR: Path = _env_path("VLOG_VIDEO_DIR", str(BASE_DIR / "videos"))
TMP_DIR: Path = _env_path("VLOG_TMP_DIR", str(BASE_DIR / "tmp"))
DATABASE_URL: str = _env_str("VLOG_DATABASE_URL",
                             f"sqlite:///{BASE_DIR / 'vlog.db'}")


@dataclass(frozen=True)
class QualityRung:
    """One rung of the adaptive-bitrate ladder."""

    name: str            # e.g. "1080p"
    height: int          # frame height; width follows the source aspect
    video_bitrate: int   # bits/sec target (0 = constant QP)
    audio_bitrate: int   # bits/sec target
    base_qp: int = 30    # the rate controller's starting QP


QUALITY_LADDER: tuple[QualityRung, ...] = (
    QualityRung("2160p", 2160, 15_000_000, 192_000, base_qp=30),
    QualityRung("1440p", 1440, 8_000_000, 192_000, base_qp=30),
    QualityRung("1080p", 1080, 5_000_000, 192_000, base_qp=30),
    QualityRung("720p", 720, 2_500_000, 128_000, base_qp=31),
    QualityRung("480p", 480, 1_000_000, 128_000, base_qp=32),
    QualityRung("360p", 360, 600_000, 96_000, base_qp=33),
)

LADDER_BY_NAME: dict[str, QualityRung] = {r.name: r for r in QUALITY_LADDER}


def ladder_for_source(source_height: int) -> tuple[QualityRung, ...]:
    """Rungs at or below the source height (never upscale), >= 1 rung."""
    rungs = tuple(r for r in QUALITY_LADDER
                  if r.height <= max(source_height, 360))
    return rungs or (QUALITY_LADDER[-1],)


SEGMENT_DURATION_S: float = _env_float("VLOG_SEGMENT_DURATION", 6.0,
                                       lo=1.0, hi=30.0)
# "cmaf" (fMP4, HLS + DASH) or "hls_ts" (MPEG-TS, HLS only)
STREAMING_FORMAT: str = _env_str("VLOG_STREAMING_FORMAT", "cmaf")
# "p" = I + P chains, "intra" = every frame an IDR.
GOP_MODE: str = _env_str("VLOG_GOP_MODE", "p")
GOP_LEN: int = _env_int("VLOG_GOP_LEN", 24, lo=1, hi=256)
MOTION_SEARCH_RADIUS: int = _env_int("VLOG_MOTION_SEARCH", 8, lo=1, hi=32)
# "cabac" (Main profile) or "cavlc" (Baseline)
H264_ENTROPY: str = _env_str("VLOG_H264_ENTROPY", "cabac")
H264_DEBLOCK: bool = _env_bool("VLOG_H264_DEBLOCK", True)
# HEVC (codec="h265"): 2NxN/Nx2N inter partitions (opt-in; partitioned
# slices entropy-code in Python) and spec-8.7.2 in-loop deblocking.
HEVC_PARTITIONS: bool = _env_bool("VLOG_HEVC_PARTITIONS", False)
HEVC_DEBLOCK: bool = _env_bool("VLOG_HEVC_DEBLOCK", True)
# Host threads for per-frame HEVC entropy coding (the C coder releases
# the GIL).
ENTROPY_THREADS: int = _env_int(
    "VLOG_ENTROPY_THREADS", max(2, min(32, os.cpu_count() or 8)),
    lo=1, hi=256)
TPU_FRAME_BATCH: int = _env_int("VLOG_TPU_FRAME_BATCH", 8, lo=1, hi=256)
PIPELINE_DEPTH: int = _env_int("VLOG_PIPELINE_DEPTH", 2, lo=1, hi=16)

# The device runtime (parallel/scheduler.py, parallel/mesh.py,
# parallel/compile_cache.py, obs/profiler.py), the JAX package's names
# and defaults. Mesh job slots: the process's devices partition into
# this many contiguous slots; a lone job still leases every device.
MESH_SLOTS: int = _env_int("VLOG_MESH_SLOTS", 1, lo=1, hi=64)
# (data x rung) grid spec ("data:-1", "data:2,rung:4" or "auto"),
# resolved by parallel.mesh.resolve_mesh_shape.
TPU_MESH_SPEC: str = _env_str("VLOG_TPU_MESH", "data:-1")
# Device-classified faults that quarantine a device, and the cadence of
# the worker's reinstatement probe sweep (0 disables it).
QUARANTINE_THRESHOLD: int = _env_int("VLOG_QUARANTINE_THRESHOLD", 1, lo=1)
DEVICE_PROBE_INTERVAL_S: float = _env_float(
    "VLOG_DEVICE_PROBE_INTERVAL_S", 60.0, lo=0.0)
# Where the nvcc and cc libraries build; empty = the package's _build/.
COMPILE_CACHE_DIR: str = _env_str("VLOG_COMPILE_CACHE_DIR", "")
# Profiler sessions: artifact root (empty = BASE_DIR/profiles) and the
# cap on one session's duration.
PROFILE_DIR: str = _env_str("VLOG_PROFILE_DIR", "")
PROFILE_MAX_S: float = _env_float("VLOG_PROFILE_MAX_S", 60.0, lo=1.0)

# Disk admission floor (storage/integrity.py::under_pressure); 0 disables.
MIN_FREE_DISK_BYTES: int = _env_int("VLOG_MIN_FREE_DISK_GB", 10, lo=0) * 1024**3

# Sprite sheets (worker/sprites.py), the JAX package's names and defaults.
SPRITE_INTERVAL_S: float = _env_float("VLOG_SPRITE_INTERVAL", 10.0, lo=1.0)
SPRITE_TILE_W: int = _env_int("VLOG_SPRITE_WIDTH", 160, lo=16)
SPRITE_TILE_H: int = _env_int("VLOG_SPRITE_HEIGHT", 90, lo=16)
SPRITE_GRID: int = 10  # 10x10 tiles per sheet
SPRITE_MAX_SHEETS: int = _env_int("VLOG_SPRITE_MAX_SHEETS", 20, lo=1)

# Transcription (asr/, worker/transcribe.py), the JAX package's names,
# defaults and bounds.
WHISPER_MODEL: str = _env_str("VLOG_WHISPER_MODEL", "small")
# Local HF-format weights directory (nothing is fetched).
WHISPER_DIR: str = _env_str("VLOG_WHISPER_DIR", "")
WHISPER_CHUNK_S: float = 30.0       # model window
WHISPER_OVERLAP_S: float = 5.0      # chunk overlap for stitching
# Beam width for decoding; 1 = greedy.
WHISPER_BEAM: int = _env_int("VLOG_WHISPER_BEAM", 5, lo=1, hi=16)
# The continuous-batching engine (asr/engine.py): widest batch per tick
# (ticks run at power-of-two buckets up to it), the coalescing delay per
# tick, and the window-queue bound (submits block past it).
ASR_BATCH_WINDOWS: int = _env_int("VLOG_ASR_BATCH_WINDOWS", 8, lo=1, hi=64)
ASR_TICK_S: float = _env_float("VLOG_ASR_TICK_S", 0.05, lo=0.0, hi=5.0)
ASR_QUEUE_MAX: int = _env_int("VLOG_ASR_QUEUE_MAX", 256, lo=8, hi=8192)
# Whisper weight storage: "f32", "bf16" (cast at use) or "int8"
# (per-output-channel symmetric, dequantized at use).
WHISPER_QUANT: str = _env_str("VLOG_WHISPER_QUANT", "f32")


# The worker daemon and the job plane under it (db/, jobs/, worker/),
# the JAX package's names, defaults and bounds.
#
# Job timeout envelope: duration x multiplier x the rung's factor,
# clamped.
TRANSCODE_TIMEOUT_MULTIPLIER: float = _env_float("VLOG_TIMEOUT_MULTIPLIER",
                                                 2.0, lo=0.1)
TIMEOUT_MIN_S: float = 300.0
TIMEOUT_MAX_S: float = 4 * 3600.0
MAX_VIDEO_DURATION_S: float = 7 * 24 * 3600.0
_RESOLUTION_TIMEOUT_MULTIPLIERS: dict[str, float] = {
    "360p": 1.0, "480p": 1.2, "720p": 1.5, "1080p": 2.0, "1440p": 2.5,
    "2160p": 3.5,
}


def transcode_timeout_s(duration_s: float, rung_name: str) -> float:
    """Timeout for one rung of one video (duration x global x resolution)."""
    mult = _RESOLUTION_TIMEOUT_MULTIPLIERS.get(rung_name, 2.0)
    raw = duration_s * TRANSCODE_TIMEOUT_MULTIPLIER * mult
    return min(max(raw, TIMEOUT_MIN_S), TIMEOUT_MAX_S)


# Claim leases, heartbeats, polling.
CLAIM_LEASE_S: int = _env_int("VLOG_CLAIM_LEASE_MINUTES", 30, lo=1) * 60
HEARTBEAT_INTERVAL_S: int = _env_int("VLOG_HEARTBEAT_INTERVAL", 30, lo=5)
WORKER_OFFLINE_THRESHOLD_S: int = _env_int("VLOG_WORKER_OFFLINE_THRESHOLD",
                                           300, lo=30)
MAX_JOB_ATTEMPTS: int = _env_int("VLOG_MAX_JOB_ATTEMPTS", 3, lo=1, hi=20)
WORKER_POLL_INTERVAL_S: float = _env_float("VLOG_WORKER_POLL_INTERVAL", 5.0,
                                           lo=0.1)
# Jobs per claim transaction, and the expired-lease sweeper's cadence
# (0 disables the loop).
CLAIM_BATCH_MAX: int = _env_int("VLOG_CLAIM_BATCH_MAX", 16, lo=1)
SWEEP_INTERVAL_S: float = _env_float("VLOG_SWEEP_INTERVAL_S", 10.0, lo=0.0)

# Multi-tenant QoS (jobs/qos.py): fleet-wide defaults a tenant inherits
# when no per-tenant setting is written.
QOS_STARVATION_S: float = _env_float("VLOG_QOS_STARVATION_S", 30.0, lo=0.1)
QOS_DEFAULT_WEIGHT: float = _env_float("VLOG_QOS_DEFAULT_WEIGHT", 1.0,
                                       lo=0.001)
QOS_MAX_QUEUED: int = _env_int("VLOG_QOS_MAX_QUEUED", 0, lo=0)
QOS_MAX_INFLIGHT: int = _env_int("VLOG_QOS_MAX_INFLIGHT", 0, lo=0)
QOS_DEADLINE_BUDGET_S: float = _env_float("VLOG_QOS_DEADLINE_BUDGET_S",
                                          120.0, lo=0.0)
QOS_RETRY_AFTER_S: float = _env_float("VLOG_QOS_RETRY_AFTER_S", 5.0, lo=0.1)
QOS_ALERT_QUEUED: int = _env_int("VLOG_QOS_ALERT_QUEUED", 0, lo=0)
QOS_ALERT_INTERVAL_S: float = _env_float("VLOG_QOS_ALERT_INTERVAL_S", 60.0,
                                         lo=1.0)
QOS_SCALE_TARGET: int = _env_int("VLOG_QOS_SCALE_TARGET", 8, lo=1)
QOS_WAIT_WINDOW_S: float = _env_float("VLOG_QOS_WAIT_WINDOW_S", 300.0,
                                      lo=10.0)

# Drain on SIGTERM or a preemption notice (worker/drain.py).
DRAIN_GRACE_S: float = _env_float("VLOG_DRAIN_GRACE_S", 120.0, lo=0.0)
PREEMPTION_FILE: str = _env_str("VLOG_PREEMPTION_FILE", "")
PREEMPTION_URL: str = _env_str("VLOG_PREEMPTION_URL", "")
PREEMPTION_POLL_S: float = _env_float("VLOG_PREEMPTION_POLL_S", 2.0, lo=0.1)

# Failure plane: retry backoff, the compute breaker, the stall watchdog,
# the coordination-plane brownout breaker.
RETRY_BACKOFF_BASE_S: float = _env_float("VLOG_RETRY_BACKOFF_BASE", 30.0,
                                         lo=0.0)
RETRY_BACKOFF_CAP_S: float = _env_float("VLOG_RETRY_BACKOFF_CAP", 1800.0,
                                        lo=0.0)
BREAKER_FAILURE_THRESHOLD: int = _env_int("VLOG_BREAKER_THRESHOLD", 5, lo=1)
BREAKER_COOLDOWN_S: float = _env_float("VLOG_BREAKER_COOLDOWN", 60.0, lo=0.0)
STALL_WINDOW_S: float = _env_float("VLOG_STALL_WINDOW", 900.0, lo=0.0)
DB_BREAKER_THRESHOLD: int = _env_int("VLOG_DB_BREAKER_THRESHOLD", 3, lo=1)
DB_BREAKER_COOLDOWN_S: float = _env_float("VLOG_DB_BREAKER_COOLDOWN", 15.0,
                                          lo=0.0)

# The Worker API (api/worker_api.py) and its remote workers
# (worker/remote.py): the server's port, the URL a worker dials, the
# registration secret (empty = dev mode, loopback only), the long-poll
# claim (server-side park bound, parked-waiter cap, re-check cadence),
# the heartbeat write-behind window (0 = write through) and the TTL of
# the /metrics database gauge block.
WORKER_API_PORT: int = _env_int("VLOG_WORKER_API_PORT", 9002, lo=1, hi=65535)
WORKER_API_URL: str = _env_str("VLOG_WORKER_API_URL",
                               f"http://127.0.0.1:{WORKER_API_PORT}")
ADMIN_SECRET: str = _env_str("VLOG_ADMIN_SECRET", "")
CLAIM_WAIT_MAX_S: float = _env_float("VLOG_CLAIM_WAIT_MAX_S", 30.0, lo=0.0)
CLAIM_MAX_WAITERS: int = _env_int("VLOG_CLAIM_MAX_WAITERS", 256, lo=1)
CLAIM_RECHECK_S: float = _env_float("VLOG_CLAIM_RECHECK_S", 2.0, lo=0.1)
HEARTBEAT_FLUSH_S: float = _env_float("VLOG_HEARTBEAT_FLUSH_S", 0.0, lo=0.0)
METRICS_DB_TTL_S: float = _env_float("VLOG_METRICS_DB_TTL_S", 5.0, lo=0.0)

# SLO plane (obs/slo.py): burn-rate windows, the alert threshold, the
# exemplar ring, the evaluation cadence of an embedding process.
SLO_FAST_WINDOW_S: float = _env_float("VLOG_SLO_FAST_WINDOW_S", 300.0,
                                      lo=10.0)
SLO_SLOW_WINDOW_S: float = _env_float("VLOG_SLO_SLOW_WINDOW_S", 3600.0,
                                      lo=60.0)
SLO_EVAL_S: float = _env_float("VLOG_SLO_EVAL_S", 30.0, lo=0.0)
SLO_EXEMPLARS: int = _env_int("VLOG_SLO_EXEMPLARS", 16, lo=1, hi=256)
SLO_BURN_ALERT: float = _env_float("VLOG_SLO_BURN_ALERT", 1.0, lo=0.1)

# Orphan GC (storage/gc.py): the age past which a temp or a worker
# workspace is reclaimable, and how long a soft-deleted video's tree
# survives.
GC_TEMP_MAX_AGE_S: float = _env_float("VLOG_GC_TEMP_MAX_AGE", 6 * 3600.0,
                                      lo=0.0)
GC_DELETED_RETENTION_S: float = _env_float("VLOG_GC_DELETED_RETENTION",
                                           7 * 86400.0, lo=0.0)

# Span persistence to job_spans (metrics stay on either way).
TRACE_ENABLED: bool = _env_bool("VLOG_TRACE_ENABLED", True)
# Whether a transcode with audio enqueues its transcription job.
TRANSCRIPTION_ENABLED: bool = _env_bool("VLOG_TRANSCRIPTION_ENABLED", True)
# Webhook targets on private or loopback networks are refused unless
# allowed.
WEBHOOK_ALLOW_PRIVATE: bool = _env_bool("VLOG_WEBHOOK_ALLOW_PRIVATE", False)

CODE_VERSION: str = "1"


def ensure_dirs() -> None:
    """Create the storage tree (idempotent)."""
    for p in (BASE_DIR, UPLOAD_DIR, VIDEO_DIR, TMP_DIR):
        p.mkdir(parents=True, exist_ok=True)
