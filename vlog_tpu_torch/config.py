"""The configuration the ported slice reads.

Same ``VLOG_*`` names and defaults as the JAX package's config (ladder,
GOP structure, entropy, deblocking, search radius, batch and pipeline
depth), so one environment configures both. Only what the H.264 I+P
CMAF path reads is here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


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
STREAMING_FORMAT: str = _env_str("VLOG_STREAMING_FORMAT", "cmaf")
# "p" = I + P chains; "intra" is not part of this slice.
GOP_MODE: str = _env_str("VLOG_GOP_MODE", "p")
GOP_LEN: int = _env_int("VLOG_GOP_LEN", 24, lo=1, hi=256)
MOTION_SEARCH_RADIUS: int = _env_int("VLOG_MOTION_SEARCH", 8, lo=1, hi=32)
H264_ENTROPY: str = _env_str("VLOG_H264_ENTROPY", "cabac")
H264_DEBLOCK: bool = _env_bool("VLOG_H264_DEBLOCK", True)
TPU_FRAME_BATCH: int = _env_int("VLOG_TPU_FRAME_BATCH", 8, lo=1, hi=256)
PIPELINE_DEPTH: int = _env_int("VLOG_PIPELINE_DEPTH", 2, lo=1, hi=16)
