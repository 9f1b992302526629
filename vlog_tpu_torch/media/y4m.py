"""YUV4MPEG2 (.y4m) reader/writer — the uncompressed interchange format.

Raw planar YUV with a one-line header; the self-contained ingest path for
tests and benchmarks (no external decoder needed), and the canonical frame
interchange between the decode stage and the TPU encode pipeline.
Only C420 (4:2:0) and C444 are supported.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from pathlib import Path
from typing import BinaryIO, Iterator

import numpy as np


class Y4mError(ValueError):
    pass


@dataclass
class Y4mInfo:
    width: int
    height: int
    fps: float
    fps_num: int
    fps_den: int
    colorspace: str          # "420" | "444"
    frame_count: int         # -1 if unseekable/unknown
    header_size: int
    frame_size: int          # bytes per FRAME payload


def _plane_sizes(width: int, height: int, colorspace: str) -> tuple[int, int]:
    y = width * height
    if colorspace == "420":
        if width % 2 or height % 2:
            raise Y4mError("C420 requires even dimensions")
        return y, (width // 2) * (height // 2)
    if colorspace == "444":
        return y, y
    raise Y4mError(f"unsupported colorspace C{colorspace}")


def parse_header(line: bytes) -> Y4mInfo:
    if not line.startswith(b"YUV4MPEG2"):
        raise Y4mError("not a YUV4MPEG2 stream")
    width = height = 0
    fps_num, fps_den = 25, 1
    colorspace = "420"
    for token in line.decode("ascii", "replace").split()[1:]:
        tag, val = token[0], token[1:]
        if tag == "W":
            width = int(val)
        elif tag == "H":
            height = int(val)
        elif tag == "F":
            n, d = val.split(":")
            fps_num, fps_den = int(n), int(d)
        elif tag == "C":
            colorspace = val.rstrip()
            if colorspace.startswith("420"):  # 420jpeg/420mpeg2/420paldv
                colorspace = "420"
    if width <= 0 or height <= 0:
        raise Y4mError("missing W/H in Y4M header")
    ysize, csize = _plane_sizes(width, height, colorspace)
    return Y4mInfo(
        width=width,
        height=height,
        fps=fps_num / fps_den,
        fps_num=fps_num,
        fps_den=fps_den,
        colorspace=colorspace,
        frame_count=-1,
        header_size=len(line) + 1,
        frame_size=ysize + 2 * csize,
    )


def probe_y4m(path: str | Path) -> Y4mInfo:
    with Y4mReader(path) as reader:
        return reader.info


class Y4mReader:
    """Frame-seekable Y4M reader.

    FRAME marker lines may legally carry parameters ("FRAME Ip\\n"), so frame
    payload offsets are indexed by scanning marker lines once at open rather
    than assuming a fixed stride.
    """

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._fp: BinaryIO = open(path, "rb")
        header = self._fp.readline()
        self.info = parse_header(header.rstrip(b"\n"))
        self.info.header_size = self._fp.tell()
        self._frame_offsets: list[int] = []  # offset of each FRAME payload
        file_size = self.path.stat().st_size
        pos = self.info.header_size
        while pos < file_size:
            self._fp.seek(pos)
            marker = self._fp.readline()
            if not marker.startswith(b"FRAME"):
                break
            payload_at = pos + len(marker)
            if payload_at + self.info.frame_size > file_size:
                break  # truncated trailing frame
            self._frame_offsets.append(payload_at)
            pos = payload_at + self.info.frame_size
        self.info.frame_count = len(self._frame_offsets)

    def close(self) -> None:
        self._fp.close()

    def __enter__(self) -> "Y4mReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def read_frame(self, index: int | None = None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (Y, U, V) uint8 planes. ``index=None`` reads sequentially."""
        info = self.info
        if index is not None:
            if not 0 <= index < len(self._frame_offsets):
                raise EOFError(f"frame {index} out of range (have {len(self._frame_offsets)})")
            self._fp.seek(self._frame_offsets[index])
        else:
            marker = self._fp.readline()
            if not marker:
                raise EOFError("end of Y4M stream")
            if not marker.startswith(b"FRAME"):
                raise Y4mError(f"bad FRAME marker: {marker[:20]!r}")
        raw = self._fp.read(info.frame_size)
        if len(raw) < info.frame_size:
            raise EOFError("truncated Y4M frame")
        w, h = info.width, info.height
        ysize, csize = _plane_sizes(w, h, info.colorspace)
        y = np.frombuffer(raw[:ysize], dtype=np.uint8).reshape(h, w)
        if info.colorspace == "420":
            cw, ch = w // 2, h // 2
        else:
            cw, ch = w, h
        u = np.frombuffer(raw[ysize : ysize + csize], dtype=np.uint8).reshape(ch, cw)
        v = np.frombuffer(raw[ysize + csize :], dtype=np.uint8).reshape(ch, cw)
        return y, u, v

    def iter_frames(self) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        for i in range(self.info.frame_count):
            yield self.read_frame(i)


def write_y4m(
    path: str | Path,
    frames: Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]] | list,
    *,
    fps_num: int = 30,
    fps_den: int = 1,
    colorspace: str = "420",
) -> int:
    """Write planar YUV frames; returns frame count."""
    count = 0
    with open(path, "wb") as fp:
        first = True
        for y, u, v in frames:
            if first:
                h, w = y.shape
                fp.write(
                    f"YUV4MPEG2 W{w} H{h} F{fps_num}:{fps_den} Ip A1:1 C{colorspace}\n".encode()
                )
                first = False
            fp.write(b"FRAME\n")
            fp.write(np.ascontiguousarray(y, dtype=np.uint8).tobytes())
            fp.write(np.ascontiguousarray(u, dtype=np.uint8).tobytes())
            fp.write(np.ascontiguousarray(v, dtype=np.uint8).tobytes())
            count += 1
    if count == 0:
        raise Y4mError("no frames to write")
    return count


def fps_to_fraction(fps: float) -> tuple[int, int]:
    frac = Fraction(fps).limit_denominator(1001)
    return frac.numerator, frac.denominator
