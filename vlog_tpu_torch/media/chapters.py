"""Chapter extraction + transcript-based suggestion (a copy of
``vlog_tpu/media/chapters.py``).

Reference parity: api/chapter_detection.py:1-448 — read embedded chapter
marks from the container (the reference used ffprobe's chapter atoms;
here the first-party MP4 parser reads the Nero ``chpl`` box and QuickTime
``udta``) and, when none exist, suggest chapters from the transcript:
long silences between cues mark section boundaries, and the following
cue's opening words become the title.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Chapter:
    start_s: float
    title: str
    source: str = "container"


def _iter_boxes(data: bytes, start: int, end: int):
    pos = start
    while pos + 8 <= end:
        size = int.from_bytes(data[pos:pos + 4], "big")
        btype = data[pos + 4:pos + 8]
        if size == 1:
            size = int.from_bytes(data[pos + 8:pos + 16], "big")
            body = pos + 16
        else:
            body = pos + 8
        if size < 8 or pos + size > end:
            return
        yield btype, body, pos + size
        pos += size


def parse_mp4_chapters(path: str | Path) -> list[Chapter]:
    """Nero ``chpl`` chapter marks from moov/udta (best-effort)."""
    data = Path(path).read_bytes()
    out: list[Chapter] = []

    def walk(start: int, end: int, inside_udta: bool = False) -> None:
        for btype, body, bend in _iter_boxes(data, start, end):
            if btype in (b"moov", b"udta"):
                walk(body, bend, inside_udta or btype == b"udta")
            elif btype == b"chpl" and inside_udta:
                _parse_chpl(data[body:bend], out)

    walk(0, len(data))
    out.sort(key=lambda c: c.start_s)
    return out


def _parse_chpl(payload: bytes, out: list[Chapter]) -> None:
    # version(1)+flags(3)+reserved(4)+count(1), then per chapter:
    # start (u64, 100ns units), title_len (u8), utf8 title
    if len(payload) < 9:
        return
    count = payload[8]
    pos = 9
    for _ in range(count):
        if pos + 9 > len(payload):
            return
        start_100ns, tlen = struct.unpack(">QB", payload[pos:pos + 9])
        pos += 9
        title = payload[pos:pos + tlen].decode("utf-8", errors="replace")
        pos += tlen
        out.append(Chapter(start_s=start_100ns / 1e7, title=title,
                           source="container"))


def suggest_from_transcript(
    cues: list,                 # asr.vtt.Cue or dicts with start_s/end_s/text
    *,
    min_gap_s: float = 4.0,
    min_chapter_s: float = 60.0,
    max_title_words: int = 6,
) -> list[Chapter]:
    """Heuristic boundaries: a silence of ``min_gap_s``+ between cues
    starts a new chapter (if the previous one is long enough); titles come
    from the next cue's opening words (reference transcript-heuristic
    suggestions)."""

    def f(c, name):
        return getattr(c, name, None) if not isinstance(c, dict) \
            else c.get(name)

    chapters: list[Chapter] = []
    if not cues:
        return chapters

    def title_of(cue) -> str:
        words = str(f(cue, "text") or "").split()
        t = " ".join(words[:max_title_words])
        return t + ("…" if len(words) > max_title_words else "")

    chapters.append(Chapter(0.0, title_of(cues[0]) or "Introduction",
                            source="transcript"))
    last_start = 0.0
    for prev, cur in zip(cues, cues[1:]):
        gap = (f(cur, "start_s") or 0.0) - (f(prev, "end_s") or 0.0)
        start = float(f(cur, "start_s") or 0.0)
        if gap >= min_gap_s and start - last_start >= min_chapter_s:
            chapters.append(Chapter(start, title_of(cur), source="transcript"))
            last_start = start
    return chapters
