"""Unified media probing — the ``get_video_info`` boundary (copy of
``vlog_tpu/media/probe.py``).

Dispatch is by magic bytes, not extension: Y4M and MP4 are read by the
port's own parsers, anything else goes to the libav ingest shim.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from vlog_tpu_torch.media import mp4 as mp4lib
from vlog_tpu_torch.media import y4m as y4mlib


class ProbeError(ValueError):
    pass


@dataclass
class VideoInfo:
    """What the upload pipeline needs to know about a source file."""

    container: str            # "mp4" | "y4m" | "libav"
    path: str                 # source file path (decode stage re-opens it)
    duration_s: float
    width: int
    height: int
    fps: float
    frame_count: int
    video_codec: str | None   # "h264" | "raw" | ...
    audio_codec: str | None
    size_bytes: int
    codec_string: str = ""    # RFC 6381 for the video track
    extras: dict = field(default_factory=dict)


def sniff_container(path: str | Path) -> str:
    with open(path, "rb") as fp:
        head = fp.read(16)
    if len(head) >= 12 and head[4:8] == b"ftyp":
        return "mp4"
    if head.startswith(b"YUV4MPEG2"):
        return "y4m"
    raise ProbeError(f"{path}: unrecognized container (magic {head[:8]!r})")


def _libav_probe(path: Path) -> VideoInfo:
    """Foreign-container probe through the libav ingest shim."""
    from vlog_tpu_torch.backends.source import (LibavFrameSource,
                                                UnsupportedSource)

    try:
        src = LibavFrameSource(path)
    except UnsupportedSource as exc:
        raise ProbeError(str(exc)) from exc
    try:
        return src.info
    finally:
        src.close()


def get_video_info(path: str | Path) -> VideoInfo:
    path = Path(path)
    if not path.exists():
        raise ProbeError(f"{path}: no such file")
    size = path.stat().st_size
    if size == 0:
        raise ProbeError(f"{path}: empty file")
    try:
        container = sniff_container(path)
    except ProbeError:
        return _libav_probe(path)

    if container == "y4m":
        info = y4mlib.probe_y4m(path)
        return VideoInfo(
            container="y4m",
            path=str(path),
            duration_s=info.frame_count / info.fps if info.fps else 0.0,
            width=info.width,
            height=info.height,
            fps=info.fps,
            frame_count=info.frame_count,
            video_codec="raw",
            audio_codec=None,
            size_bytes=size,
        )

    try:
        movie = mp4lib.parse_mp4(path)
    except Exception:  # noqa: BLE001 — exotic MP4s fall to the libav probe
        return _libav_probe(path)
    video = movie.video
    audio = movie.audio
    if video is None and audio is None:
        raise ProbeError(f"{path}: MP4 has no playable tracks")
    return VideoInfo(
        container="mp4",
        path=str(path),
        duration_s=movie.duration_s,
        width=video.width if video else 0,
        height=video.height if video else 0,
        fps=round(video.fps, 3) if video else 0.0,
        frame_count=video.samples.count if video else 0,
        video_codec=video.codec if video else None,
        audio_codec=audio.codec if audio else None,
        size_bytes=size,
        codec_string=video.codec_string() if video else "",
        extras={"movie_timescale": movie.movie_timescale},
    )
