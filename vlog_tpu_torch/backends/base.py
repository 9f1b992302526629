"""Plan and result types of the backend (subset of
``vlog_tpu/backends/base.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from vlog_tpu_torch import config
from vlog_tpu_torch.media.probe import VideoInfo


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
    streaming_format: str = "cmaf"
    gop_len: int = 1


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
    wall_s: float = 0.0
    variants: list = field(default_factory=list)
    fps: float = 0.0
    segment_duration_s: float = 0.0
    # seconds per stage: decode, device (program + synchronize), pull
    # (device -> host copies), entropy (host CABAC), package (fMP4 writes)
    stage_s: dict = field(default_factory=dict)
    gop_len: int = 1


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
