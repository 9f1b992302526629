"""MP4 (progressive ISO-BMFF) demuxing and probing (copy of
``vlog_tpu/media/mp4.py``).

Replaces the reference's ffprobe/ffmpeg demux subprocess calls
(transcoder.py:706-813 get_video_info, hwaccel.py:864-981 codec-string
extraction) with first-party parsing of the moov sample tables into numpy
arrays, giving O(1) random access to any sample for the decode stage.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import BinaryIO

import numpy as np

from vlog_tpu_torch.media.boxes import Box, parse_box_tree


class Mp4Error(ValueError):
    """Malformed or unsupported MP4 structure."""


@dataclass
class SampleTable:
    """Flattened per-sample addressing (absolute offsets, sizes, timing)."""

    sizes: np.ndarray          # u32[n]
    offsets: np.ndarray        # u64[n] absolute file offsets
    dts: np.ndarray            # u64[n] decode timestamps (track timescale)
    durations: np.ndarray      # u32[n]
    cts_offsets: np.ndarray | None = None   # s32[n] composition offsets
    sync_indices: np.ndarray | None = None  # indices of sync samples; None = all

    @property
    def count(self) -> int:
        return int(self.sizes.shape[0])

    def is_sync(self, index: int) -> bool:
        if self.sync_indices is None:
            return True
        return bool(np.isin(index, self.sync_indices))


@dataclass
class TrackInfo:
    track_id: int
    handler: str               # "vide" | "soun" | other
    codec: str                 # "h264" | "hevc" | "aac" | fourcc fallback
    timescale: int
    duration: int              # in track timescale units
    samples: SampleTable
    width: int = 0
    height: int = 0
    codec_config: bytes = b""  # avcC / hvcC / esds payload
    sample_entry: bytes = b""  # full stsd entry payload (for passthrough remux)
    sample_entry_type: str = ""
    channels: int = 0
    sample_rate: int = 0

    @property
    def duration_s(self) -> float:
        return self.duration / self.timescale if self.timescale else 0.0

    @property
    def fps(self) -> float:
        if self.handler != "vide" or self.samples.count == 0 or self.duration == 0:
            return 0.0
        return self.samples.count * self.timescale / self.duration

    def codec_string(self) -> str:
        """RFC 6381 codec string (reference: hwaccel.py:864-981 analog)."""
        if self.codec == "h264" and len(self.codec_config) >= 4:
            # avcC: configurationVersion, AVCProfileIndication,
            # profile_compatibility, AVCLevelIndication
            return "avc1.%02X%02X%02X" % (
                self.codec_config[1], self.codec_config[2], self.codec_config[3]
            )
        if self.codec == "aac":
            return "mp4a.40.2"
        return self.codec


@dataclass
class MovieInfo:
    path: str
    movie_timescale: int
    duration_s: float
    tracks: list[TrackInfo] = field(default_factory=list)

    @property
    def video(self) -> TrackInfo | None:
        return next((t for t in self.tracks if t.handler == "vide"), None)

    @property
    def audio(self) -> TrackInfo | None:
        return next((t for t in self.tracks if t.handler == "soun"), None)


# --------------------------------------------------------------------------
# Sample-table parsing
# --------------------------------------------------------------------------

def _parse_stts(payload: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Returns (durations[n_samples], dts[n_samples])."""
    count = struct.unpack(">I", payload[4:8])[0]
    entries = np.frombuffer(payload[8 : 8 + count * 8], dtype=">u4").reshape(count, 2)
    durations = np.repeat(entries[:, 1].astype(np.uint32), entries[:, 0])
    dts = np.zeros(durations.shape[0], dtype=np.uint64)
    if durations.shape[0] > 1:
        dts[1:] = np.cumsum(durations[:-1], dtype=np.uint64)
    return durations, dts


def _parse_stsz(payload: bytes) -> np.ndarray:
    uniform, count = struct.unpack(">II", payload[4:12])
    if uniform:
        return np.full(count, uniform, dtype=np.uint32)
    return np.frombuffer(payload[12 : 12 + count * 4], dtype=">u4").astype(np.uint32)


def _parse_chunk_offsets(stco: Box | None, co64: Box | None) -> np.ndarray:
    if co64 is not None:
        count = struct.unpack(">I", co64.payload[4:8])[0]
        return np.frombuffer(co64.payload[8 : 8 + count * 8], dtype=">u8").astype(np.uint64)
    if stco is None:
        raise Mp4Error("missing stco/co64")
    count = struct.unpack(">I", stco.payload[4:8])[0]
    return np.frombuffer(stco.payload[8 : 8 + count * 4], dtype=">u4").astype(np.uint64)


def _parse_stsc(payload: bytes, n_chunks: int) -> np.ndarray:
    """Expand sample-to-chunk runs into per-chunk sample counts."""
    count = struct.unpack(">I", payload[4:8])[0]
    entries = np.frombuffer(payload[8 : 8 + count * 12], dtype=">u4").reshape(count, 3)
    per_chunk = np.zeros(n_chunks, dtype=np.uint32)
    for i in range(count):
        first = int(entries[i, 0]) - 1
        spc = int(entries[i, 1])
        last = int(entries[i + 1, 0]) - 1 if i + 1 < count else n_chunks
        per_chunk[first:last] = spc
    return per_chunk


def _sample_offsets(
    sizes: np.ndarray, chunk_offsets: np.ndarray, samples_per_chunk: np.ndarray
) -> np.ndarray:
    """Absolute file offset of every sample."""
    n = sizes.shape[0]
    offsets = np.zeros(n, dtype=np.uint64)
    idx = 0
    for chunk_i in range(chunk_offsets.shape[0]):
        spc = int(samples_per_chunk[chunk_i])
        if spc == 0:
            continue
        end = min(idx + spc, n)
        chunk_sizes = sizes[idx:end].astype(np.uint64)
        starts = np.zeros(end - idx, dtype=np.uint64)
        if end - idx > 1:
            starts[1:] = np.cumsum(chunk_sizes[:-1])
        offsets[idx:end] = chunk_offsets[chunk_i] + starts
        idx = end
        if idx >= n:
            break
    return offsets


def _parse_track(trak: Box) -> TrackInfo | None:
    mdia = trak.find("mdia")
    if mdia is None:
        return None
    hdlr = mdia.find("hdlr")
    handler = hdlr.payload[8:12].decode("latin-1") if hdlr else "????"
    mdhd = mdia.find("mdhd")
    if mdhd is None:
        return None
    version = mdhd.payload[0]
    if version == 1:
        timescale, duration = struct.unpack(">IQ", mdhd.payload[20:32])
    else:
        timescale, duration = struct.unpack(">II", mdhd.payload[12:20])

    tkhd = trak.find("tkhd")
    track_id = 0
    if tkhd is not None:
        track_id = struct.unpack(
            ">I", tkhd.payload[12:16] if tkhd.payload[0] == 0 else tkhd.payload[20:24]
        )[0]

    stbl = mdia.find("minf", "stbl")
    if stbl is None:
        return None

    # stsd: first sample entry
    stsd = stbl.find("stsd")
    codec = "unknown"
    width = height = 0
    codec_config = b""
    sample_entry = b""
    entry_type = ""
    channels = 0
    sample_rate = 0
    if stsd is not None and len(stsd.payload) > 16:
        entry_size = struct.unpack(">I", stsd.payload[8:12])[0]
        entry_type = stsd.payload[12:16].decode("latin-1")
        sample_entry = stsd.payload[8 : 8 + entry_size]
        body = sample_entry[8:]  # skip size+type
        if handler == "vide" and len(body) >= 78:
            width, height = struct.unpack(">HH", body[24:28])
            codec = {"avc1": "h264", "avc3": "h264", "hvc1": "hevc", "hev1": "hevc",
                     "av01": "av1"}.get(entry_type, entry_type)
            codec_config = _find_subbox(body[78:], {"avcC", "hvcC", "av1C"})
        elif handler == "soun" and len(body) >= 28:
            channels, _bits = struct.unpack(">HH", body[8:12])
            sample_rate = struct.unpack(">I", body[16:20])[0] >> 16
            codec = {"mp4a": "aac", "opus": "opus", "lpcm": "pcm", "sowt": "pcm",
                     "twos": "pcm", "ipcm": "pcm"}.get(entry_type, entry_type)
            codec_config = _find_subbox(body[28:], {"esds", "dOps", "pcmC"})

    stts = stbl.find("stts")
    stsz = stbl.find("stsz")
    stsc = stbl.find("stsc")
    if stts is None or stsz is None or stsc is None:
        raise Mp4Error(f"track {track_id}: missing sample tables")
    durations, dts = _parse_stts(stts.payload)
    sizes = _parse_stsz(stsz.payload)
    chunk_offsets = _parse_chunk_offsets(stbl.find("stco"), stbl.find("co64"))
    per_chunk = _parse_stsc(stsc.payload, chunk_offsets.shape[0])
    n = sizes.shape[0]
    if durations.shape[0] < n:  # tolerate short stts (pad w/ last duration)
        pad = np.full(n - durations.shape[0], durations[-1] if durations.size else 1,
                      dtype=np.uint32)
        durations = np.concatenate([durations, pad])
        dts = np.zeros(n, dtype=np.uint64)
        dts[1:] = np.cumsum(durations[:-1], dtype=np.uint64)
    offsets = _sample_offsets(sizes, chunk_offsets, per_chunk)

    cts = None
    ctts = stbl.find("ctts")
    if ctts is not None:
        count = struct.unpack(">I", ctts.payload[4:8])[0]
        entries = np.frombuffer(ctts.payload[8 : 8 + count * 8], dtype=">u4").reshape(count, 2)
        cts = np.repeat(entries[:, 1].astype(np.int64), entries[:, 0]).astype(np.int32)[:n]

    sync = None
    stss = stbl.find("stss")
    if stss is not None:
        count = struct.unpack(">I", stss.payload[4:8])[0]
        sync = (
            np.frombuffer(stss.payload[8 : 8 + count * 4], dtype=">u4").astype(np.int64) - 1
        )

    return TrackInfo(
        track_id=track_id,
        handler=handler,
        codec=codec,
        timescale=timescale,
        duration=duration,
        samples=SampleTable(sizes, offsets, dts, durations[:n], cts, sync),
        width=width,
        height=height,
        codec_config=codec_config,
        sample_entry=sample_entry,
        sample_entry_type=entry_type,
        channels=channels,
        sample_rate=sample_rate,
    )


def _find_subbox(data: bytes, wanted: set[str]) -> bytes:
    """Scan a sample-entry tail for a config box, returning its payload."""
    pos = 0
    while pos + 8 <= len(data):
        size = struct.unpack(">I", data[pos : pos + 4])[0]
        btype = data[pos + 4 : pos + 8].decode("latin-1")
        if size < 8:
            break
        if btype in wanted:
            return data[pos + 8 : pos + size]
        pos += size
    return b""


# --------------------------------------------------------------------------
# Public API
# --------------------------------------------------------------------------

def parse_mp4(path: str | Path) -> MovieInfo:
    """Parse moov into track + sample-table info (no media bytes read)."""
    path = Path(path)
    with open(path, "rb") as fp:
        tree = parse_box_tree(fp)
    moov = next((b for b in tree if b.type == "moov"), None)
    if moov is None:
        raise Mp4Error(f"{path}: no moov box (not a progressive MP4?)")
    mvhd = moov.find("mvhd")
    if mvhd is None:
        raise Mp4Error(f"{path}: moov missing mvhd")
    if mvhd.payload[0] == 1:
        timescale, duration = struct.unpack(">IQ", mvhd.payload[20:32])
    else:
        timescale, duration = struct.unpack(">II", mvhd.payload[12:20])
    tracks = [t for t in (_parse_track(tr) for tr in moov.find_all("trak")) if t]
    return MovieInfo(
        path=str(path),
        movie_timescale=timescale,
        duration_s=duration / timescale if timescale else 0.0,
        tracks=tracks,
    )


class SampleReader:
    """Random-access sample extraction from a progressive MP4."""

    def __init__(self, path: str | Path, track: TrackInfo):
        self._fp: BinaryIO = open(path, "rb")
        self.track = track

    def close(self) -> None:
        self._fp.close()

    def __enter__(self) -> "SampleReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def read_sample(self, index: int) -> bytes:
        st = self.track.samples
        if not 0 <= index < st.count:
            raise IndexError(index)
        self._fp.seek(int(st.offsets[index]))
        return self._fp.read(int(st.sizes[index]))

    def read_range(self, start: int, count: int) -> list[bytes]:
        return [self.read_sample(i) for i in range(start, min(start + count, self.track.samples.count))]
