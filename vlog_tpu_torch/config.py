"""The configuration the ported slice reads.

Same ``VLOG_*`` names and defaults as the JAX package's config (ladder,
GOP structure, entropy, deblocking, search radius, batch and pipeline
depth, sprite sheets, transcription, the device runtime), so one
environment configures both. Only what the port's H.264 paths (I+P or
intra-only, CMAF or MPEG-TS), its HEVC path, its pipeline, its sprite
worker, its transcription worker and its device runtime read is here.
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
BASE_DIR: Path = Path(os.environ.get("VLOG_BASE_DIR", "./data")).expanduser()
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
