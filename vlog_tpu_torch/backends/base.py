"""Accelerator boundary: backend protocol, capability model, registry,
and the plan and result types (port of ``vlog_tpu/backends/base.py``).

A :class:`Backend` maps a source + ladder to an executable plan and runs
it; the worker pipeline never imports a concrete backend. Registering a
backend is one :func:`register_backend` call, and the registry's
factories take the torch device the backend computes on.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Protocol

import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.media.probe import VideoInfo

# progress callback: (done, total, message)
ProgressFn = Callable[[int, int, str], None]
# the first frame's JPEG at the root of every ladder tree
THUMBNAIL_NAME = "thumbnail.jpg"


@dataclass(frozen=True)
class Capabilities:
    """What an accelerator can do."""

    backend: str                       # registry name, e.g. "torch"
    device_kind: str                   # "gpu" | "cpu"
    device_count: int
    codecs: tuple[str, ...]            # encodeable codecs
    decode_codecs: tuple[str, ...]     # decodeable codecs
    max_parallel_jobs: int = 1
    memory_bytes: int | None = None
    details: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "backend": self.backend,
            "device_kind": self.device_kind,
            "device_count": self.device_count,
            "codecs": list(self.codecs),
            "decode_codecs": list(self.decode_codecs),
            "max_parallel_jobs": self.max_parallel_jobs,
            "memory_bytes": self.memory_bytes,
            **self.details,
        }


@dataclass(frozen=True)
class PlannedRung:
    """One ladder rung with resolved output geometry."""

    name: str
    width: int
    height: int
    video_bitrate: int
    qp: int
    codec: str = "h264"
    audio_bitrate: int = 0


@dataclass
class ExecutionPlan:
    """Everything the backend needs to run one transcode job."""

    source: VideoInfo
    rungs: tuple[PlannedRung, ...]
    out_dir: Path
    segment_duration_s: float = 6.0
    frame_batch: int = 8
    fps_num: int = 30
    fps_den: int = 1
    total_frames: int = 0
    streaming_format: str = "cmaf"     # "cmaf" (fMP4) or "hls_ts"
    thumbnail: bool = True
    # I+P chain length; 1 = all-intra. Always divides frames-per-segment
    # so every segment starts on an IDR.
    gop_len: int = 1
    # hls_ts mode: {audio_bitrate: (list_of_adts_frames, sample_rate)},
    # muxed into each variant's TS segments
    audio_adts: dict | None = None


@dataclass
class RungResult:
    name: str
    width: int
    height: int
    codec_string: str
    segment_count: int
    bytes_written: int
    mean_psnr_y: float | None
    achieved_bitrate: int
    playlist_path: str
    target_bitrate: int = 0


@dataclass
class RunResult:
    rungs: list[RungResult]
    frames_processed: int
    duration_s: float
    thumbnail_path: str | None = None
    wall_s: float = 0.0
    variants: list = field(default_factory=list)
    fps: float = 0.0
    segment_duration_s: float = 0.0
    # seconds per stage: decode, device (program + synchronize), pull
    # (device -> host copies), entropy (host CABAC/CAVLC), package
    # (segment writes), thumbnail
    stage_s: dict = field(default_factory=dict)
    gop_len: int = 1
    # segments (summed across rungs) taken from disk by a resumed run
    resumed_segments: int = 0


def plan_rung_geometry(src_w: int, src_h: int, rung: config.QualityRung,
                       codec: str = "h264") -> PlannedRung:
    """Height from the ladder, width from the source aspect, both even."""
    h = min(rung.height, src_h if src_h % 2 == 0 else src_h - 1)
    h = h - (h % 2)
    w = round(src_w * h / src_h / 2) * 2 if src_h else h * 16 // 9
    return PlannedRung(
        name=rung.name, width=max(w, 2), height=max(h, 2),
        video_bitrate=rung.video_bitrate, qp=rung.base_qp, codec=codec,
        audio_bitrate=getattr(rung, "audio_bitrate", 0),
    )


class Backend(Protocol):
    """Accelerator backend protocol."""

    name: str
    device: torch.device          # where the backend computes

    def detect(self) -> Capabilities: ...

    def plan(self, source: VideoInfo, rungs, out_dir: Path,
             **opts) -> ExecutionPlan: ...

    def run(self, plan: ExecutionPlan, progress_cb: ProgressFn | None = None,
            *, resume: bool = True) -> RunResult: ...


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

# name -> factory(device) -> Backend
_REGISTRY: dict[str, Callable[..., Backend]] = {}
# device -> the backend select_backend chose for it
_SELECTED: dict[str, Backend] = {}


def register_backend(name: str, factory: Callable[..., Backend]) -> None:
    _REGISTRY[name] = factory


def available_backends() -> list[str]:
    return list(_REGISTRY)


def get_backend(name: str, device: str | torch.device = "cuda") -> Backend:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None
    return factory(device=device)


def select_backend(preference: str | None = None, *,
                   device: str | torch.device = "cuda") -> Backend:
    """Pick the best available backend on ``device``.

    Explicit preference first, then whichever registered backend reports
    a GPU, then anything. A backend that cannot be built or whose
    ``detect()`` raises is skipped; with none left, selection raises (so
    a machine without CUDA gets an error, not a CPU run). The choice is
    cached per device for the process: probing may open the card, once,
    not per job.
    """
    if preference:
        return get_backend(preference, device)
    key = str(device)
    if key in _SELECTED:
        return _SELECTED[key]
    best, skipped = None, []
    for name in _REGISTRY:
        try:
            b = get_backend(name, device)
            caps = b.detect()
        except Exception as exc:   # noqa: BLE001 — a broken backend is
            skipped.append(f"{name}: {exc}")   # skipped, not fatal
            continue
        if caps.device_kind == "gpu":
            best = b
            break
        if best is None:
            best = b
    if best is None:
        raise RuntimeError(
            "no backends registered (or none detectable on "
            f"{key!r}): {'; '.join(skipped) or 'registry empty'}")
    _SELECTED[key] = best
    return best
