"""Atomic file publication.

Everything under a video's output tree must appear atomically: the
streaming uploader (worker/remote.py) and the resume scanner
(backends/jax_backend.py) both treat *existence* as *stability*, the same
contract the reference's segment watcher relies on
(segment_watcher.py:23-26 size-stability polling). tmp+rename within one
directory is atomic on POSIX.
"""

from __future__ import annotations

import os
from pathlib import Path


def atomic_write_bytes(path: str | Path, data: bytes) -> None:
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def atomic_write_text(path: str | Path, text: str) -> None:
    atomic_write_bytes(path, text.encode())


def prepare_init_segment(rdir, init_bytes: bytes,
                         config_tag: str | None = None) -> bool:
    """Write this run's init segment; returns True when the pre-existing
    one was byte-identical (segments on disk may then be resumed onto).

    On mismatch, stale ``segment_*.m4s`` files are DELETED before the
    new init lands: they reference another PPS, and leaving them on disk
    lets an interrupted restart be mistaken for resumable state on the
    following run (init would match, stale tail segments would ship).
    Deleting first keeps every crash window safe — no init on disk reads
    as a mismatch next time, and the segments are already gone.

    ``config_tag`` covers encoder configuration that does NOT change the
    init segment bytes — e.g. H.264 deblocking is a per-slice flag, so a
    VLOG_H264_DEBLOCK flip leaves SPS/PPS (and init.mp4) identical while
    old segments would mix idc values with new ones. The tag is stored
    in ``encoder.tag`` beside the init and participates in the same
    match-or-invalidate decision."""
    init_path = rdir / "init.mp4"
    tag_path = rdir / "encoder.tag"
    try:
        matched = init_path.read_bytes() == init_bytes
    except OSError:
        matched = False
    if config_tag is not None and matched:
        try:
            matched = tag_path.read_text() == config_tag
        except OSError:
            matched = False
    if not matched:
        for seg in rdir.glob("segment_*.m4s"):
            seg.unlink(missing_ok=True)
    atomic_write_bytes(init_path, init_bytes)
    if config_tag is not None:
        atomic_write_text(tag_path, config_tag)
    return matched
