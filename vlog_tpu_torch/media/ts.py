"""MPEG-TS segment muxing for legacy HLS (``streaming_format="hls_ts"``;
copy of ``vlog_tpu/media/ts.py``).

A single-program transport stream muxer: PAT/PMT with MPEG CRC32, PES
packetization with PTS (and PCR on the video PID), adaptation-field
stuffing, continuity counters, random-access indicators on IDR.

Layout notes (ISO 13818-1): 188-byte packets; PSI carried with
pointer_field; H.264 in Annex-B with an AUD per access unit; AAC as
ADTS frames.
"""

from __future__ import annotations

from dataclasses import dataclass

TS_PACKET = 188
PAT_PID = 0x0000
PMT_PID = 0x1000
VIDEO_PID = 0x0100
AUDIO_PID = 0x0101
PCR_PID = VIDEO_PID

STREAM_TYPE_H264 = 0x1B
STREAM_TYPE_AAC_ADTS = 0x0F

_CRC_TABLE = []


def _crc32_mpeg(data: bytes) -> int:
    """MPEG-2 PSI CRC32 (poly 0x04C11DB7, init 0xFFFFFFFF, no reflection)."""
    global _CRC_TABLE
    if not _CRC_TABLE:
        for i in range(256):
            c = i << 24
            for _ in range(8):
                c = ((c << 1) ^ 0x04C11DB7) if c & 0x80000000 else (c << 1)
            _CRC_TABLE.append(c & 0xFFFFFFFF)
    crc = 0xFFFFFFFF
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[((crc >> 24) ^ b) & 0xFF]
    return crc


@dataclass
class TsSample:
    """One access unit for the muxer. ``data`` is Annex-B (video) or ADTS
    (audio); times in 90 kHz ticks."""

    data: bytes
    pts: int
    is_idr: bool = True


# Access unit delimiter: primary_pic_type 7 ("any") + rbsp stop bit.
AUD_NAL = b"\x00\x00\x00\x01\x09\xf0"


class TsMuxer:
    """Stateful per-rendition muxer; continuity counters persist across
    segments (HLS requires continuous counters within a playlist)."""

    def __init__(self, *, has_video: bool = True, has_audio: bool = False):
        self.has_video = has_video
        self.has_audio = has_audio
        self._cc = {PAT_PID: 0, PMT_PID: 0, VIDEO_PID: 0, AUDIO_PID: 0}

    # -- PSI ---------------------------------------------------------------

    def _psi_packet(self, pid: int, table: bytes) -> bytes:
        payload = b"\x00" + table          # pointer_field
        header = bytearray(4)
        header[0] = 0x47
        header[1] = 0x40 | (pid >> 8)      # payload_unit_start
        header[2] = pid & 0xFF
        header[3] = 0x10 | self._cc[pid]   # payload only
        self._cc[pid] = (self._cc[pid] + 1) & 0xF
        pkt = bytes(header) + payload
        return pkt + b"\xff" * (TS_PACKET - len(pkt))

    def _pat(self) -> bytes:
        body = bytearray()
        body += (1).to_bytes(2, "big")                 # program_number
        body += (0xE000 | PMT_PID).to_bytes(2, "big")
        sec = bytearray([0x00])                        # table_id PAT
        length = 5 + len(body) + 4
        sec += (0xB000 | length).to_bytes(2, "big")
        sec += (1).to_bytes(2, "big")                  # transport_stream_id
        sec += bytes([0xC1, 0x00, 0x00])               # version/current, sec 0/0
        sec += body
        sec += _crc32_mpeg(bytes(sec)).to_bytes(4, "big")
        return self._psi_packet(PAT_PID, bytes(sec))

    def _pmt(self) -> bytes:
        streams = bytearray()
        if self.has_video:
            streams += bytes([STREAM_TYPE_H264])
            streams += (0xE000 | VIDEO_PID).to_bytes(2, "big")
            streams += (0xF000).to_bytes(2, "big")     # es_info_length 0
        if self.has_audio:
            streams += bytes([STREAM_TYPE_AAC_ADTS])
            streams += (0xE000 | AUDIO_PID).to_bytes(2, "big")
            streams += (0xF000).to_bytes(2, "big")
        body = bytearray()
        body += (0xE000 | PCR_PID if self.has_video
                 else 0xE000 | AUDIO_PID).to_bytes(2, "big")
        body += (0xF000).to_bytes(2, "big")            # program_info_length 0
        body += streams
        sec = bytearray([0x02])                        # table_id PMT
        sec += (0xB000 | (len(body) + 9)).to_bytes(2, "big")
        sec += (1).to_bytes(2, "big")                  # program_number
        sec += bytes([0xC1, 0x00, 0x00])
        sec += body
        sec += _crc32_mpeg(bytes(sec)).to_bytes(4, "big")
        return self._psi_packet(PMT_PID, bytes(sec))

    # -- PES ---------------------------------------------------------------

    @staticmethod
    def _pts_field(pts: int, tag: int) -> bytes:
        pts &= (1 << 33) - 1
        return bytes([
            (tag << 4) | (((pts >> 30) & 7) << 1) | 1,
            (pts >> 22) & 0xFF,
            (((pts >> 15) & 0x7F) << 1) | 1,
            (pts >> 7) & 0xFF,
            ((pts & 0x7F) << 1) | 1,
        ])

    def _pes(self, stream_id: int, data: bytes, pts: int) -> bytes:
        header = self._pts_field(pts, 2)               # PTS only (no B frames)
        pes_len = 3 + len(header) + len(data)
        if stream_id == 0xE0 or pes_len > 0xFFFF:
            pes_len = 0                                # unbounded (video ok)
        return (b"\x00\x00\x01" + bytes([stream_id])
                + pes_len.to_bytes(2, "big")
                + bytes([0x80, 0x80, len(header)]) + header + data)

    def _packetize(self, pid: int, pes: bytes, *, rai: bool,
                   pcr: int | None) -> bytes:
        out = bytearray()
        pos = 0
        first = True
        n = len(pes)
        while pos < n:
            remaining = n - pos
            # adaptation-field flag bytes (first packet only)
            flags = bytearray()
            if first and (rai or pcr is not None):
                flags = bytearray([0])
                if rai:
                    flags[0] |= 0x40               # random_access_indicator
                if pcr is not None:
                    flags[0] |= 0x10
                    base = pcr & ((1 << 33) - 1)
                    flags += bytes([
                        (base >> 25) & 0xFF, (base >> 17) & 0xFF,
                        (base >> 9) & 0xFF, (base >> 1) & 0xFF,
                        ((base & 1) << 7) | 0x7E, 0x00,
                    ])
            room = TS_PACKET - 4 - (1 + len(flags) if flags else 0)
            if remaining >= room:
                adapt_field = bytes([len(flags)]) + bytes(flags) \
                    if flags else b""
                take = room
            else:
                # stuff via the adaptation field to fill exactly 188
                stuff = room - remaining
                if not flags:
                    # introduce the field: costs its length byte (and a
                    # flags byte when more than one stuffing byte fits)
                    if stuff == 1:
                        adapt_field = b"\x00"          # length-0 field
                    else:
                        adapt_field = bytes([stuff - 1, 0]) \
                            + b"\xff" * (stuff - 2)
                else:
                    adapt_field = bytes([len(flags) + stuff]) \
                        + bytes(flags) + b"\xff" * stuff
                take = remaining
            header = bytes([
                0x47,
                (0x40 if first else 0x00) | (pid >> 8),
                pid & 0xFF,
                (0x30 if adapt_field else 0x10) | self._cc[pid],
            ])
            self._cc[pid] = (self._cc[pid] + 1) & 0xF
            out += header + adapt_field + pes[pos:pos + take]
            pos += take
            first = False
        return bytes(out)

    # -- public ------------------------------------------------------------

    def mux_segment(self, video: list[TsSample] | None = None,
                    audio: list[TsSample] | None = None) -> bytes:
        """One HLS segment: PAT + PMT + interleaved PES, 188-byte aligned."""
        out = bytearray()
        out += self._pat()
        out += self._pmt()
        events: list[tuple[int, int, TsSample]] = []
        for s in video or []:
            events.append((s.pts, 0, s))
        for s in audio or []:
            events.append((s.pts, 1, s))
        events.sort(key=lambda e: (e[0], e[1]))
        first_video = True
        for pts, kind, s in events:
            if kind == 0:
                data = AUD_NAL + s.data
                pcr = s.pts if first_video or s.is_idr else None
                first_video = False
                out += self._packetize(
                    VIDEO_PID, self._pes(0xE0, data, s.pts),
                    rai=s.is_idr, pcr=pcr)
            else:
                out += self._packetize(
                    AUDIO_PID, self._pes(0xC0, s.data, s.pts),
                    rai=False, pcr=None if self.has_video else s.pts)
        return bytes(out)
