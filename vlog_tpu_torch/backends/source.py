"""Frame sources: uniform batch iteration over supported containers (port
of ``vlog_tpu/backends/source.py``).

Supported inputs: Y4M (raw 4:2:0), progressive MP4 with our H.264
envelope (the first-party decoder, ``codecs/h264/decoder.py``, whose
reconstruction runs on the source's device), and anything the optional
libav ingest shim decodes. Batches are uint8 numpy (y, u, v) stacks
whatever the source; the backend uploads them.

One difference from the JAX package: ``Mp4H264FrameSource.read_batches``
keeps the frame-exact contract that ``exact_seek`` states for I+P
streams. A read that starts at frame k decodes from the last IDR at or
before k (or continues from where the previous read stopped, when that
lies in between) and drops the frames before k, so it returns frames
k, k+1, ... of a sequential decode from frame 0 on a fresh source and
after any earlier read. The JAX package decodes from sample k itself,
which is right only where k is an IDR or continues a sequential read
(ROADMAP Queue C item 7).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Iterator

import numpy as np

from vlog_tpu_torch.codecs.h264 import syntax
from vlog_tpu_torch.codecs.h264.decoder import (DecodeError, H264Decoder,
                                                UnsupportedStream)
from vlog_tpu_torch.device import resolve_device
from vlog_tpu_torch.media import mp4 as mp4mod
from vlog_tpu_torch.media import y4m
from vlog_tpu_torch.media.probe import (VideoInfo, get_video_info,
                                        sniff_container)


class UnsupportedSource(ValueError):
    """Container/codec outside the first-party decode envelope."""


class FrameSource:
    """Iterate (y, u, v) uint8 numpy batches of up to ``batch`` frames."""

    info: VideoInfo
    frame_count: int
    fps_num: int
    fps_den: int
    # True: start_frame addressing is frame-exact and frame_count is
    # authoritative (our containers). False: libav fallback — counts are
    # container estimates and mid-stream starts are keyframe-coarse, so
    # the backend disables segment resume.
    exact_seek: bool = True

    def read_batches(self, batch: int, start_frame: int = 0
                     ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Y4mFrameSource(FrameSource):
    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.info = get_video_info(path)
        self._reader = y4m.Y4mReader(path)
        self.frame_count = self._reader.info.frame_count
        self.fps_num = self._reader.info.fps_num
        self.fps_den = self._reader.info.fps_den

    def read_batches(self, batch: int, start_frame: int = 0):
        n = self.frame_count
        i = start_frame
        while i < n:
            count = min(batch, n - i)
            ys, us, vs = [], [], []
            for j in range(i, i + count):
                y, u, v = self._reader.read_frame(j)
                ys.append(y)
                us.append(u)
                vs.append(v)
            yield np.stack(ys), np.stack(us), np.stack(vs)
            i += count

    def close(self):
        self._reader.close()


def _has_idr(sample: bytes, length_size: int) -> bool:
    """Whether an AVCC sample carries an IDR slice NAL (headers only)."""
    pos = 0
    while pos + length_size < len(sample):
        ln = int.from_bytes(sample[pos:pos + length_size], "big")
        pos += length_size
        if sample[pos] & 0x1F == syntax.NAL_IDR:
            return True
        pos += ln
    return False


class Mp4H264FrameSource(FrameSource):
    """Progressive MP4 with H.264 inside the first-party envelope.

    ``device`` (default ``"cuda"``) is where the decoder reconstructs;
    the decoder's position (``_next``: the sample it decodes next, its
    reference picture being the one before) lets a read continue forward
    instead of restarting at the IDR. ``frames_decoded`` counts the
    samples decoded, dropped ones included.
    """

    def __init__(self, path: str | Path, device="cuda"):
        self.path = Path(path)
        self.device = resolve_device(device)
        self.info = get_video_info(path)
        movie = mp4mod.parse_mp4(path)
        track = movie.video
        if track is None:
            raise UnsupportedSource(f"{path}: no video track")
        if track.codec != "h264":
            raise UnsupportedSource(
                f"{path}: codec {track.codec!r} has no first-party decoder")
        self._track = track
        self._reader = mp4mod.SampleReader(path, track)
        self._decoder = self._new_decoder()
        self._next: int | None = 0
        self.frames_decoded = 0
        self.frame_count = track.samples.count
        fps = track.fps or 30.0
        self.fps_num, self.fps_den = y4m.fps_to_fraction(fps)

    def _new_decoder(self) -> H264Decoder:
        return H264Decoder(avcc_config=self._track.codec_config,
                           device=self.device)

    def _idr_at_or_before(self, k: int) -> int:
        """The last sync sample at or before ``k`` that is an IDR (stss
        first, then the NAL type); 0 when there is none."""
        sync = self._track.samples.sync_indices
        cands = (range(k, -1, -1) if sync is None
                 else sorted((int(i) for i in sync if i <= k), reverse=True))
        length_size = self._decoder._length_size
        for i in cands:
            if _has_idr(self._reader.read_sample(i), length_size):
                return i
        return 0

    def _decode(self, start: int, count: int) -> list:
        """Decode samples start..start+count-1 from the decoder's state."""
        samples = self._reader.read_range(start, count)
        self._next = None            # unknown until the decode succeeds
        try:
            frames = self._decoder.decode_samples(samples)
        except UnsupportedStream as exc:
            raise UnsupportedSource(f"{self.path}: {exc}") from exc
        if len(frames) != len(samples):
            raise UnsupportedSource(
                f"{self.path}: sample {start}+ produced no frame")
        self.frames_decoded += len(frames)
        self._next = start + len(frames)
        return frames

    def _seek(self, k: int, chunk: int) -> None:
        """Put the decoder just before frame ``k``: continue from its
        position when that lies between the IDR and ``k``, else restart
        at the IDR; decode and drop the frames in between."""
        start = self._idr_at_or_before(k)
        if self._next is not None and start <= self._next <= k:
            start = self._next
        else:
            self._decoder = self._new_decoder()
            self._next = start
        while start < k:
            start += len(self._decode(start, min(chunk, k - start)))

    def read_batches(self, batch: int, start_frame: int = 0):
        n = self.frame_count
        i = start_frame
        while i < n:
            count = min(batch, n - i)
            if self._next != i:
                self._seek(i, max(count, 1))
            frames = self._decode(i, count)
            yield (np.stack([f.y for f in frames]),
                   np.stack([f.u for f in frames]),
                   np.stack([f.v for f in frames]))
            i += count

    def close(self):
        self._reader.close()


class LibavFrameSource(FrameSource):
    """Foreign-upload decode through the system libav shim.

    CABAC/B-frame H.264, HEVC, VP9, MKV/MOV/... decode into the same
    (y, u, v) batch stream the first-party sources produce. Encode stays
    first-party; ``exact_seek`` is False (container frame counts are
    estimates; mid-stream starts are keyframe-coarse).
    """

    exact_seek = False

    def __init__(self, path: str | Path):
        from vlog_tpu_torch.native import VtAvInfo, get_av_lib

        lib = get_av_lib()
        if lib is None:
            raise UnsupportedSource(
                f"{path}: outside the first-party decode envelope and the "
                "libav ingest shim is unavailable")
        self._lib = lib
        self.path = Path(path)
        self._avinfo = VtAvInfo()
        self._handle = lib.vt_av_open(str(path).encode(),
                                      ctypes.byref(self._avinfo))
        if not self._handle:
            raise UnsupportedSource(f"{path}: libav cannot open this input")
        ai = self._avinfo
        if ai.width <= 0 or ai.height <= 0:
            self.close()
            raise UnsupportedSource(f"{path}: no decodable video stream")
        if ai.width % 2 or ai.height % 2:
            # Reject at PROBE time, not mid-transcode: 4:2:0 needs even
            # dimensions end to end.
            self.close()
            raise UnsupportedSource(
                f"{path}: odd frame dimensions "
                f"{ai.width}x{ai.height} unsupported")
        fps = ai.fps if ai.fps > 0 else 30.0
        self.fps_num, self.fps_den = y4m.fps_to_fraction(fps)
        n = int(ai.nb_frames) if ai.nb_frames > 0 else int(
            round(ai.duration * fps))
        self.frame_count = max(n, 1)
        self.info = VideoInfo(
            container="libav", path=str(path),
            duration_s=float(ai.duration), width=int(ai.width),
            height=int(ai.height), fps=round(fps, 3),
            frame_count=self.frame_count,
            video_codec=ai.vcodec.decode(errors="replace"),
            audio_codec=(ai.acodec.decode(errors="replace")
                         if ai.has_audio else None),
            size_bytes=self.path.stat().st_size,
        )
        self._pos = 0

    def _seek_to(self, start_frame: int) -> None:
        """Seek to the prior keyframe, then decode-and-discard forward
        until the stream's PTS reaches the target time (bounded)."""
        fps = self.fps_num / self.fps_den
        target_t = start_frame / fps
        if self._lib.vt_av_seek(self._handle, target_t) != 0 \
                and start_frame < self._pos:
            raise UnsupportedSource(f"{self.path}: seek failed")
        h, w = self.info.height, self.info.width
        fsz = w * h * 3 // 2
        buf = np.empty(fsz, np.uint8)
        pts = ctypes.c_double(-1.0)
        # budget bounds pathological streams (e.g. keyframe-free)
        for _ in range(2000):
            # Peek one frame; stop once its pts reaches target (within
            # half a frame). The peeked frame is the NEXT one yielded —
            # stash it.
            got = self._lib.vt_av_read_pts(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(pts), 1)
            if got <= 0:
                self._stash = None
                break
            if pts.value < 0 or pts.value >= target_t - 0.5 / fps:
                self._stash = buf.copy()
                break
        else:
            self._stash = None
        self._pos = start_frame

    def read_batches(self, batch: int, start_frame: int = 0):
        if start_frame != self._pos:
            self._seek_to(start_frame)
        h, w = self.info.height, self.info.width
        fsz = w * h * 3 // 2

        def emit(frames: np.ndarray):
            n = frames.shape[0]
            ys = frames[:, : h * w].reshape(n, h, w).copy()
            us = frames[:, h * w: h * w + (h // 2) * (w // 2)].reshape(
                n, h // 2, w // 2).copy()
            vs = frames[:, h * w + (h // 2) * (w // 2):].reshape(
                n, h // 2, w // 2).copy()
            return ys, us, vs

        stash = getattr(self, "_stash", None)
        self._stash = None
        if stash is not None:
            self._pos += 1
            yield emit(stash[None, :])
        buf = np.empty(batch * fsz, np.uint8)
        while True:
            got = self._lib.vt_av_read(
                self._handle,
                buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                batch)
            if got < 0:
                raise UnsupportedSource(f"{self.path}: libav decode error")
            if got == 0:
                return
            self._pos += int(got)
            yield emit(buf[: got * fsz].reshape(int(got), fsz))
            if got < batch:
                return

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.vt_av_close(self._handle)
            self._handle = None


def _trial_decode(src: Mp4H264FrameSource) -> None:
    """Parse the first sample so envelope violations (at the PPS or the
    first slice) surface at OPEN time, letting open_source fall back to
    libav before any work happens."""
    samples = src._reader.read_range(0, 1)
    if samples:
        src._new_decoder().decode_sample_levels(samples[0])


def open_source(path: str | Path, device="cuda") -> FrameSource:
    """Sniff the container and return the right FrameSource.

    First-party decoders are preferred (frame-exact, resume-capable); an
    MP4 decodes on ``device``. Anything outside their envelope falls back
    to the libav ingest shim when it is available.
    """
    try:
        kind = sniff_container(path)
    except Exception:
        kind = "libav"
    if kind == "y4m":
        return Y4mFrameSource(path)
    if kind == "mp4":
        src = None
        try:
            src = Mp4H264FrameSource(path, device)
            _trial_decode(src)
            return src
        except (UnsupportedSource, UnsupportedStream, DecodeError,
                ValueError):
            # outside the first-party envelope; try libav — without
            # leaking the half-open first-party reader
            if src is not None:
                src.close()
    return LibavFrameSource(path)
