"""CMAF fMP4 muxing: init segment + media segments (the subset of
``vlog_tpu/media/fmp4.py`` the H.264 ladder writer needs).

One track per file, fixed timescale, movie fragments with one trun.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from vlog_tpu_torch.media.boxes import (
    IDENTITY_MATRIX,
    box,
    fixed16_16,
    full_box,
    u16,
    u32,
    u64,
)



@dataclass
class Sample:
    data: bytes            # AVCC length-prefixed NAL units (video) / raw frame (audio)
    duration: int          # in track timescale units
    is_sync: bool = True
    cts_offset: int = 0



def avc1_sample_entry(width: int, height: int, avcc: bytes) -> bytes:
    return box(
        "avc1",
        b"\x00" * 6 + u16(1),       # reserved + data_reference_index
        u16(0) + u16(0),            # pre_defined + reserved
        b"\x00" * 12,               # pre_defined
        u16(width) + u16(height),
        u32(0x00480000) * 2,        # 72 dpi horiz/vert
        u32(0),                     # reserved
        u16(1),                     # frame_count
        b"\x00" * 32,               # compressorname
        u16(0x0018),                # depth = 24
        struct.pack(">h", -1),      # pre_defined
        box("avcC", avcc),
    )


# --------------------------------------------------------------------------
# Shared moov machinery
# --------------------------------------------------------------------------

def _mvhd(timescale: int, duration: int) -> bytes:
    return full_box(
        "mvhd", 0, 0,
        u32(0), u32(0),             # creation/modification time
        u32(timescale), u32(duration),
        u32(0x00010000),            # rate 1.0
        u16(0x0100), u16(0),        # volume, reserved
        u32(0) * 2,                 # reserved
        IDENTITY_MATRIX,
        u32(0) * 6,                 # pre_defined
        u32(0xFFFFFFFF),            # next_track_ID
    )


def _tkhd(track_id: int, duration: int, width: int, height: int) -> bytes:
    return full_box(
        "tkhd", 0, 7,               # flags: enabled | in movie | in preview
        u32(0), u32(0),
        u32(track_id), u32(0), u32(duration),
        u32(0) * 2,
        u16(0), u16(0), u16(0x0100 if width == 0 else 0), u16(0),
        IDENTITY_MATRIX,
        fixed16_16(width), fixed16_16(height),
    )


def _mdhd(timescale: int, duration: int) -> bytes:
    return full_box(
        "mdhd", 0, 0,
        u32(0), u32(0), u32(timescale), u32(duration),
        u16(0x55C4),                # language = "und"
        u16(0),
    )


def _hdlr(handler: str, name: str) -> bytes:
    return full_box(
        "hdlr", 0, 0,
        u32(0), handler.encode("latin-1"), u32(0) * 3,
        name.encode() + b"\x00",
    )


def _dinf() -> bytes:
    return box("dinf", full_box("dref", 0, 0, u32(1), full_box("url ", 0, 1)))


def _media_header(handler: str) -> bytes:
    if handler == "vide":
        return full_box("vmhd", 0, 1, u16(0), u16(0) * 3)
    return full_box("smhd", 0, 0, u16(0), u16(0))


@dataclass
class TrackConfig:
    track_id: int
    handler: str               # "vide" | "soun"
    timescale: int
    sample_entry: bytes        # serialized stsd entry (avc1_sample_entry(...))
    width: int = 0
    height: int = 0



# --------------------------------------------------------------------------
# CMAF: init segment + media segments
# --------------------------------------------------------------------------

def init_segment(track: TrackConfig) -> bytes:
    """ftyp + moov(mvex) with empty sample tables (CMAF header)."""
    stbl = box(
        "stbl",
        full_box("stsd", 0, 0, u32(1), track.sample_entry),
        full_box("stts", 0, 0, u32(0)),
        full_box("stsc", 0, 0, u32(0)),
        full_box("stsz", 0, 0, u32(0), u32(0)),
        full_box("stco", 0, 0, u32(0)),
    )
    minf = box("minf", _media_header(track.handler), _dinf(), stbl)
    mdia = box("mdia", _mdhd(track.timescale, 0), _hdlr(track.handler, "vlog_tpu"), minf)
    trak = box("trak", _tkhd(track.track_id, 0, track.width, track.height), mdia)
    mvex = box(
        "mvex",
        full_box("trex", 0, 0, u32(track.track_id), u32(1), u32(0), u32(0), u32(0)),
    )
    moov = box("moov", _mvhd(track.timescale, 0), trak, mvex)
    ftyp = box("ftyp", b"iso5", u32(512), b"iso5iso6cmfcmp41dash")
    return ftyp + moov


_TRUN_FLAGS = 0x000001 | 0x000100 | 0x000200 | 0x000400 | 0x000800
# data-offset | sample-duration | sample-size | sample-flags | sample-cts

_SYNC_FLAGS = 0x02000000      # sample_depends_on = 2 (independent)
_NONSYNC_FLAGS = 0x01010000   # depends_on = 1, non-sync


def media_segment(
    track: TrackConfig,
    sequence_number: int,
    base_decode_time: int,
    samples: list[Sample],
) -> bytes:
    """styp + moof + mdat movie fragment (one CMAF chunk/segment)."""
    styp = box("styp", b"msdh", u32(0), b"msdhmsix")
    mfhd = full_box("mfhd", 0, 0, u32(sequence_number))
    # default-base-is-moof (0x020000): data offsets relative to moof start
    tfhd = full_box("tfhd", 0, 0x020000, u32(track.track_id))
    tfdt = full_box("tfdt", 1, 0, u64(base_decode_time))

    trun_body = bytearray()
    trun_body += u32(len(samples))
    data_offset_pos = len(trun_body)
    trun_body += u32(0)  # patched below
    for s in samples:
        trun_body += u32(s.duration)
        trun_body += u32(len(s.data))
        trun_body += u32(_SYNC_FLAGS if s.is_sync else _NONSYNC_FLAGS)
        trun_body += struct.pack(">i", s.cts_offset)
    trun = full_box("trun", 1, _TRUN_FLAGS, bytes(trun_body))

    traf = box("traf", tfhd, tfdt, trun)
    moof = box("moof", mfhd, traf)
    # data_offset = moof size + mdat header (8) relative to moof start
    data_offset = len(moof) + 8
    # patch inside the assembled moof: locate trun payload
    moof = bytearray(moof)
    # trun is the last child of traf which is the last child of moof;
    # find its payload offset by scanning back: full_box header is 12 bytes
    # (size+type+version/flags), then 4 bytes sample_count, then data_offset.
    trun_start = len(moof) - len(trun)
    patch_at = trun_start + 12 + 4
    moof[patch_at : patch_at + 4] = u32(data_offset)
    mdat = box("mdat", b"".join(s.data for s in samples))
    return styp + bytes(moof) + mdat
