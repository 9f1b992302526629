"""Source probe for the port (Y4M only; subset of
``vlog_tpu/media/probe.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

from vlog_tpu_torch.media import y4m


@dataclass
class VideoInfo:
    """What the backend needs to know about a source file."""

    container: str            # "y4m"
    path: str
    duration_s: float
    width: int
    height: int
    fps: float
    frame_count: int
    video_codec: str | None
    audio_codec: str | None
    size_bytes: int


def get_video_info(path: str | Path) -> VideoInfo:
    path = Path(path)
    info = y4m.probe_y4m(path)
    return VideoInfo(
        container="y4m", path=str(path),
        duration_s=info.frame_count / info.fps if info.fps else 0.0,
        width=info.width, height=info.height, fps=info.fps,
        frame_count=info.frame_count, video_codec="raw", audio_codec=None,
        size_bytes=path.stat().st_size)
