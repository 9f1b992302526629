"""RFC 6381 codec strings recovered from init segments (a copy of
``vlog_tpu/media/codecstr.py``).

Manifest regeneration (admin manifests/regenerate; reference CLI
``manifests-regenerate``) rebuilds master.m3u8/manifest.mpd from the
database plus the on-disk rung trees — but the DB stores only the short
codec name ('h264'), not the profile/level string the master needs.
The authoritative source is each rung's init.mp4: avcC carries the
exact three bytes avc1 strings are made of, hvcC the profile/tier/
level fields, av1C the sequence profile/level/bitdepth.
"""

from __future__ import annotations


def _find_box(data: bytes, name: bytes) -> int:
    """Offset of the PAYLOAD of the first box named ``name`` (boxes are
    length-prefixed but a flat scan is unambiguous for these 4CCs)."""
    i = data.find(name)
    return -1 if i < 0 else i + 4


def codec_string_from_init(init: bytes) -> str | None:
    """Best-effort RFC 6381 string for the (single) video track.
    Damaged/truncated boxes yield None, never an exception — the
    manifest-repair path runs this on possibly-corrupt trees."""
    i = _find_box(init, b"avcC")
    if i >= 0 and len(init) >= i + 4:
        # configurationVersion, AVCProfileIndication,
        # profile_compatibility, AVCLevelIndication
        p, c, l = init[i + 1], init[i + 2], init[i + 3]
        return f"avc1.{p:02X}{c:02X}{l:02X}"
    i = _find_box(init, b"hvcC")
    if i >= 0 and len(init) >= i + 13:
        b = init[i + 1]
        # general_profile_space (2 bits): nonzero prefixes the profile
        # with a letter (A/B/C per RFC 6381 / ISO 14496-15 E.3)
        space = (b >> 6) & 0x3
        prefix = "" if space == 0 else chr(ord("A") + space - 1)
        profile_idc = b & 0x1F
        tier = "H" if b & 0x20 else "L"
        compat = int.from_bytes(init[i + 2:i + 6], "big")
        # compatibility flags are stored bit-reversed in the string
        rev = int(f"{compat:032b}"[::-1], 2)
        level = init[i + 12]
        # general_constraint bytes: trailing zero bytes are dropped, and
        # an all-zero group is omitted entirely (no trailing ".00")
        cons = init[i + 6:i + 12].rstrip(b"\x00")
        cons_s = "".join(f".{x:02X}" for x in cons)
        return f"hvc1.{prefix}{profile_idc}.{rev:X}.{tier}{level}{cons_s}"
    i = _find_box(init, b"av1C")
    if i >= 0 and len(init) >= i + 3:
        return _av1_string(init, i)
    return None


def _av1_string(init: bytes, i: int) -> str:
    b1, b2 = init[i + 1], init[i + 2]
    profile = (b1 >> 5) & 0x7
    level = b1 & 0x1F
    tier = "H" if b2 & 0x80 else "M"
    high_bd = (b2 >> 6) & 1
    twelve = (b2 >> 5) & 1
    bd = 12 if (high_bd and twelve) else (10 if high_bd else 8)
    return f"av01.{profile}.{level:02d}{tier}.{bd:02d}"


def codec_string_from_ts(segment: bytes) -> str | None:
    """avc1 string recovered from an MPEG-TS segment (legacy hls_ts
    rungs have no init.mp4): scan for an SPS NAL start code — the three
    bytes after the NAL header ARE the avc1 string bytes.  SPS repeats
    at every IDR, so a packet boundary splitting one occurrence just
    means the next one matches."""
    i = 0
    while True:
        i = segment.find(b"\x00\x00\x01", i)
        if i < 0 or i + 7 > len(segment):
            return None
        nal = segment[i + 3]
        if (nal & 0x1F) == 7 and (nal & 0x80) == 0:
            p, c, l = segment[i + 4], segment[i + 5], segment[i + 6]
            return f"avc1.{p:02X}{c:02X}{l:02X}"
        i += 3
