"""The configuration the ported slice reads.

Same ``VLOG_*`` names and defaults as the JAX package's config (ladder,
GOP structure, entropy, deblocking, search radius, batch and pipeline
depth, sprite sheets, transcription, the device runtime), so one
environment configures both. Only what the port's H.264 paths (I+P or
intra-only, CMAF or MPEG-TS), its HEVC and AV1 paths, its pipeline, its
sprite worker, its transcription worker, its device runtime, its worker
daemon with the job plane under it, and its API servers (Worker, public
and admin) read is here.
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
# The admin API's upload cap (api/admin_api.py: the app's
# client_max_size and the streamed-size check).
MAX_UPLOAD_SIZE_BYTES: int = _env_int(
    "VLOG_MAX_UPLOAD_SIZE_GB", 50, lo=1, hi=1024
) * 1024**3


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
# AV1 delegated-encoder speed (libaom cpu-used 0-8 / SVT preset) of the
# codec="av1" re-encode (backends/av1_path.py).
AV1_SPEED: int = _env_int("VLOG_AV1_SPEED", 8, lo=0, hi=8)
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
# The admin API process's periodic orphan-GC sweep (storage/gc.py); 0
# disables the loop (the admin trigger endpoint still works).
GC_INTERVAL_S: float = _env_float("VLOG_GC_INTERVAL", 3600.0, lo=0.0)

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

# Default fractional tolerance for the bench-trend regression gate
# (obs/benchtrend.py): the latest record of a series may fall this far
# below the best prior (or rise this far above it for lower-is-better
# metrics) before it flags. Per-metric overrides live in the module.
BENCHTREND_TOL: float = _env_float("VLOG_BENCHTREND_TOL", 0.5, lo=0.01)

# The public API (api/public_api.py): its port, and whether the source
# upload (``original*``) is downloadable.
PUBLIC_PORT: int = _env_int("VLOG_PUBLIC_PORT", 9000, lo=1, hi=65535)
# The admin API (api/admin_api.py): its port, and the Secure flag of its
# session cookie (set it behind TLS).
ADMIN_PORT: int = _env_int("VLOG_ADMIN_PORT", 9001, lo=1, hi=65535)
ADMIN_COOKIE_SECURE: bool = _env_bool("VLOG_ADMIN_COOKIE_SECURE", False)
DOWNLOADS_ENABLED: bool = _env_bool("VLOG_DOWNLOADS_ENABLED", False)

# The delivery plane under the public API's media route (delivery/): the
# L1 segment cache, admission, the disk L2, the peer ring, gossip,
# hedged fills and prewarm. The JAX package's names and defaults.

# Byte budget of the in-memory LRU segment cache (0 disables caching;
# requests still flow through the same response function, so cached and
# uncached responses stay byte-identical).
DELIVERY_CACHE_BYTES: int = _env_int(
    "VLOG_DELIVERY_CACHE_BYTES", 256 * 1024**2, lo=0)
# Distinct cache-miss disk reads allowed in flight at once; misses past
# the bound answer 503 + Retry-After instead of queueing on the volume
# (single-flight already collapses same-segment misses to one read).
DELIVERY_MAX_INFLIGHT_READS: int = _env_int(
    "VLOG_DELIVERY_MAX_INFLIGHT_READS", 64, lo=1)
# Mutable manifests (.m3u8/.mpd) cache for this long; segments are
# immutable (digest-keyed) and live until evicted or invalidated.
DELIVERY_MANIFEST_TTL_S: float = _env_float(
    "VLOG_DELIVERY_MANIFEST_TTL", 2.0, lo=0.0)
# Segment bodies are pinned by default (0): in-process invalidation
# covers every publish/re-encode path and steady state stays
# zero-syscall. In a SPLIT deployment — trees mutated by an admin or
# worker PROCESS the serving process can't see — invalidation cannot
# fan out, so set a TTL here to bound how long a republished segment
# may serve stale from this cache.
DELIVERY_SEGMENT_TTL_S: float = _env_float(
    "VLOG_DELIVERY_SEGMENT_TTL", 0.0, lo=0.0)
# Publish-state (slug -> ready/deleted/missing) cache TTL: the window in
# which a publish/delete in ANOTHER process may be stale here. In-process
# mutations invalidate explicitly and are visible immediately.
DELIVERY_STATE_TTL_S: float = _env_float(
    "VLOG_DELIVERY_STATE_TTL", 5.0, lo=0.0)
# Objects larger than this bypass the buffer cache and stream from disk
# (sized well above any 4-6 s segment; catches source downloads).
DELIVERY_MAX_ENTRY_BYTES: int = _env_int(
    "VLOG_DELIVERY_MAX_ENTRY_BYTES", 32 * 1024**2, lo=1)

# -- distributed tier (L2 + peer-fill + prewarm + sendfile) --------------

# Byte budget of the disk-backed L2 below the RAM LRU (0 disables the
# disk tier entirely). Entries spill here on L1 eviction and on fill;
# every read back is sha256-verified against the publish manifest before
# it can serve, so a corrupt or truncated spill refills instead of
# serving.
DELIVERY_L2_BYTES: int = _env_int("VLOG_DELIVERY_L2_BYTES", 0, lo=0)
# Directory holding the digest-named L2 store (content-addressed:
# <sha256[:2]>/<sha256>). Safe to wipe at any time — it is purely a
# warm-set cache rebuilt from the origin tree.
DELIVERY_L2_DIR: Path = _env_path(
    "VLOG_DELIVERY_L2_DIR", str(BASE_DIR / "delivery-l2"))
# Comma-separated base URLs of every origin process in the delivery
# ring (including this one). Empty = no ring: every miss fills from
# local disk. With a ring, a miss on a non-owner origin fetches the
# object from its rendezvous-hash owner over the public /videos route
# (digest-checked) before falling back to local disk.
DELIVERY_PEERS: tuple[str, ...] = tuple(
    u.strip().rstrip("/") for u in
    _env_str("VLOG_DELIVERY_PEERS", "").split(",") if u.strip())
# This process's own base URL as it appears in VLOG_DELIVERY_PEERS, so
# the ring can tell "I am the owner" from "fetch from the owner". Empty
# with a non-empty ring means this process owns nothing (pure edge).
DELIVERY_SELF_URL: str = _env_str(
    "VLOG_DELIVERY_SELF_URL", "").rstrip("/")
# Per-object peer-fetch budget; a slow or down owner past this falls
# back to local fill and starts a short cooldown for that peer.
DELIVERY_PEER_TIMEOUT_S: float = _env_float(
    "VLOG_DELIVERY_PEER_TIMEOUT", 2.0, lo=0.1)
# How many leading media segments of each rung finalize_ready warms
# into the cache (plus every init segment). 0 disables prewarm.
DELIVERY_PREWARM_SEGMENTS: int = _env_int(
    "VLOG_DELIVERY_PREWARM_SEGMENTS", 2, lo=0)
# L2 hits at or above this size serve zero-copy (os.sendfile via a
# file response) instead of buffering into the RAM LRU; smaller hits
# promote to L1 as usual.
DELIVERY_SENDFILE_BYTES: int = _env_int(
    "VLOG_DELIVERY_SENDFILE_BYTES", 8 * 1024**2, lo=1)
# How long a peer that failed a fill (transport error or non-503
# status) sits out before fills route to it again. A 503 shed with a
# Retry-After header overrides this with the peer's own number.
DELIVERY_PEER_COOLDOWN_S: float = _env_float(
    "VLOG_DELIVERY_PEER_COOLDOWN_S", 5.0, lo=0.0)

# -- self-healing fabric (gossip membership + hedged fills + heat) -------

# Mean seconds between gossip heartbeat rounds (each round probes every
# known peer over GET /api/delivery/gossip). 0 disables the probe loop:
# membership then moves only on fill failures/successes.
DELIVERY_GOSSIP_INTERVAL_S: float = _env_float(
    "VLOG_DELIVERY_GOSSIP_INTERVAL", 1.0, lo=0.0)
# Probe-interval jitter as a fraction of the interval (bounded to
# [interval*(1-j), interval*(1+j)]) so N origins never probe in
# lockstep and suspect windows desynchronize across the fleet.
DELIVERY_GOSSIP_JITTER: float = _env_float(
    "VLOG_DELIVERY_GOSSIP_JITTER", 0.25, lo=0.0, hi=0.9)
# Consecutive transport/timeout failures (probe or fill) before an
# alive peer turns suspect. Suspects keep their ring ownership but
# fills route around them immediately.
DELIVERY_GOSSIP_SUSPECT_AFTER: int = _env_int(
    "VLOG_DELIVERY_GOSSIP_SUSPECT_AFTER", 2, lo=1)
# A suspect silent this long goes down: it leaves the ownership set and
# the ring version bumps, so rendezvous routing rebalances its keys.
# One successful heartbeat rejoins it.
DELIVERY_GOSSIP_DOWN_S: float = _env_float(
    "VLOG_DELIVERY_GOSSIP_DOWN", 3.0, lo=0.0)
# How long a digest-liar peer (served bytes failing the manifest sha256
# check) is quarantined out of the ownership set, regardless of
# reachability.
DELIVERY_GOSSIP_QUARANTINE_S: float = _env_float(
    "VLOG_DELIVERY_GOSSIP_QUARANTINE", 60.0, lo=0.0)
# Latency budget before a miss routed to the owner launches a hedge
# fill to the next-ranked peer (first digest-valid response wins, the
# loser is cancelled). Once enough fill samples accumulate the budget
# adapts to the observed p95 fill latency, clamped to [this/4, 4*this].
# 0 disables hedging.
DELIVERY_HEDGE_MS: float = _env_float(
    "VLOG_DELIVERY_HEDGE_MS", 250.0, lo=0.0)
# Half-life (seconds) of the per-slug exponential heat decay behind
# popularity-aware L2 admission. Heat rises by 1 per request to the
# slug and halves every this-many seconds.
DELIVERY_HEAT_HALFLIFE_S: float = _env_float(
    "VLOG_DELIVERY_HEAT_HALFLIFE", 300.0, lo=1.0)
# Minimum slug heat for a body to be admitted into the disk L2
# (one-hit-wonders bypass the spill). 0 admits everything — the
# pre-fabric behavior.
DELIVERY_L2_ADMIT_HEAT: float = _env_float(
    "VLOG_DELIVERY_L2_ADMIT_HEAT", 0.0, lo=0.0)
# Slugs at or above this heat resist L2 eviction: the sweep gives their
# entries a second chance (bounded) and evicts colder bytes first.
# 0 keeps pure LRU eviction.
DELIVERY_L2_HOT_HEAT: float = _env_float(
    "VLOG_DELIVERY_L2_HOT_HEAT", 0.0, lo=0.0)

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
