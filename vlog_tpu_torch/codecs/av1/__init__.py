"""AV1 bitstream helpers for the delegated-encode path (a copy of
``vlog_tpu/codecs/av1/__init__.py``).

Only the container-facing pieces are first-party: walking a temporal
unit's OBUs, parsing the sequence header's profile/level/tier (AV1 spec
5.5.1 — the fields the av1C record and the RFC 6381 string need), and
building the ``av01.P.LLT.DD`` codec string. The encode itself is
delegated to the system encoder libraries (backends/av1_path.py).
"""

from __future__ import annotations

OBU_SEQUENCE_HEADER = 1


class _Bits:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def f(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


def _leb128(data: bytes, pos: int) -> tuple[int, int]:
    value, shift = 0, 0
    while True:
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if not (b & 0x80):
            return value, pos
        shift += 7


def iter_obus(tu: bytes):
    """Yield (obu_type, payload) over a low-overhead temporal unit."""
    pos = 0
    n = len(tu)
    while pos < n:
        header = tu[pos]
        obu_type = (header >> 3) & 0xF
        has_ext = (header >> 2) & 1
        has_size = (header >> 1) & 1
        pos += 1 + has_ext
        if has_size:
            size, pos = _leb128(tu, pos)
        else:
            size = n - pos
        yield obu_type, tu[pos:pos + size]
        pos += size


def parse_seq_header(tu: bytes) -> tuple[int, int, int]:
    """(seq_profile, seq_level_idx[0], seq_tier[0]) from a temporal unit
    containing a sequence header OBU (keyframe TUs carry one in-band).

    Covers the field layout system encoders emit (no decoder model /
    timing info is the libaom/SVT default); falls back to safe values if
    an unusual layout defeats the walk."""
    try:
        obus = list(iter_obus(tu))
    except IndexError:      # truncated/malformed TU: safe defaults
        return 0, 8, 0
    for obu_type, payload in obus:
        if obu_type != OBU_SEQUENCE_HEADER:
            continue
        try:
            r = _Bits(payload)
            profile = r.f(3)
            r.f(1)                          # still_picture
            reduced = r.f(1)
            if reduced:
                return profile, r.f(5), 0
            timing_present = r.f(1)
            if timing_present:
                # timing_info: num_units_in_tick + time_scale +
                # equal_picture_interval (uvlc skipped -> bail to safe)
                r.f(32)
                r.f(32)
                if r.f(1):
                    return profile, 8, 0    # level 3.0, Main tier
                if r.f(1):                  # decoder_model_info_present
                    return profile, 8, 0
            r.f(1)                          # initial_display_delay_present
            r.f(5)                          # operating_points_cnt_minus_1
            r.f(12)                         # operating_point_idc[0]
            level = r.f(5)
            tier = r.f(1) if level > 7 else 0
            return profile, level, tier
        except IndexError:
            return 0, 8, 0
    return 0, 8, 0


def codec_string_from_tu(meta: dict | None) -> str:
    """RFC 6381 av01 string from parsed sequence-header fields."""
    if not meta:
        return "av01.0.08M.08"
    tier = "H" if meta.get("tier") else "M"
    return (f"av01.{meta.get('profile', 0)}."
            f"{meta.get('level', 8):02d}{tier}.08")
