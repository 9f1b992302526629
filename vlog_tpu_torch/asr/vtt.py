"""WebVTT writing and cross-window cue stitching.

A copy of ``vlog_tpu/asr/vtt.py`` (host-side, numpy).

Reference parity: worker/transcription.py:45-58 (generate_webvtt) — cue
timestamps as HH:MM:SS.mmm with blank-line-separated cues. Stitching
handles the 30 s window overlap our batched decoder introduces (the
reference's faster-whisper seeks sequentially instead; SURVEY §5 maps
that to data-parallel windows + overlap stitching).
"""

from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass
class Cue:
    start_s: float
    end_s: float
    text: str


def _ts(t: float) -> str:
    t = max(0.0, t)
    h = int(t // 3600)
    m = int(t % 3600 // 60)
    s = t % 60
    return f"{h:02d}:{m:02d}:{s:06.3f}"


def _escape_cue_text(text: str) -> str:
    """WebVTT cue text treats & and < as markup starters (WebVTT 3.4);
    transcripts with literal ampersands/angle brackets must escape or
    conformant parsers drop/garble the cue."""
    return (text.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def format_vtt(cues: list[Cue]) -> str:
    lines = ["WEBVTT", ""]
    for c in cues:
        text = c.text.strip()
        if not text:
            continue
        lines.append(f"{_ts(c.start_s)} --> {_ts(max(c.end_s, c.start_s))}")
        lines.append(_escape_cue_text(text))
        lines.append("")
    return "\n".join(lines) + ("\n" if lines[-1] else "")


_WS = re.compile(r"\s+")


def clean_text(text: str) -> str:
    return _WS.sub(" ", text).strip()


def stitch_windows(window_cues: list[list[Cue]]) -> list[Cue]:
    """Merge per-window cue lists (already in absolute time) in order,
    dropping overlap-region duplicates: a cue fully covered by what has
    already been emitted is skipped; a partially-covered cue is clamped.
    """
    out: list[Cue] = []
    emitted_until = 0.0
    for cues in window_cues:
        for c in sorted(cues, key=lambda c: (c.start_s, c.end_s)):
            text = clean_text(c.text)
            if not text:
                continue
            if c.end_s <= emitted_until + 0.2:
                continue
            start = max(c.start_s, emitted_until)
            out.append(Cue(start, c.end_s, text))
            emitted_until = c.end_s
    return out
