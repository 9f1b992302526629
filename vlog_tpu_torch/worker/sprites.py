"""Sprite-sheet timeline generation (seek-preview thumbnails; port of
``vlog_tpu/worker/sprites.py``).

One pass producing ``sprites/sprite_%02d.jpg`` tile sheets (10x10 by
default) plus a WebVTT index mapping time ranges to
``sheet.jpg#xywh=`` regions, each file published atomically. The
sampled frames are decoded first-party (``backends/source.py``; an MP4
decodes on the device), the resize to tile size runs on the device (the
fused resize kernel on CUDA, its plain version on the CPU), so do the
BT.709 colour conversion and the JPEG DCT; the sheets are Huffman-coded
on the host.

The sheet cap (config.SPRITE_MAX_SHEETS) bounds work on very long videos
by widening the sampling interval.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.backends.base import ProgressFn
from vlog_tpu_torch.backends.source import open_source
from vlog_tpu_torch.codecs.jpeg import encode_jpeg_rgb
from vlog_tpu_torch.device import resolve_device
from vlog_tpu_torch.ops.colorspace import yuv420_to_rgb
from vlog_tpu_torch.ops.fused_resize import resize_yuv420
from vlog_tpu_torch.parallel.ladder import ladder_matrices, mats_from_numpy
from vlog_tpu_torch.utils.fsio import atomic_write_bytes, atomic_write_text


@dataclass
class SpriteResult:
    sheet_count: int
    tile_count: int
    interval_s: float
    vtt_path: str
    sheet_paths: list[str]


def _fmt_ts(t: float) -> str:
    h = int(t // 3600)
    m = int(t % 3600 // 60)
    s = t % 60
    return f"{h:02d}:{m:02d}:{s:06.3f}"


def plan_interval(duration_s: float, *, interval_s: float, grid: int,
                  max_sheets: int) -> tuple[float, int]:
    """Widen the interval until the sheet budget holds; returns
    (interval, tile_count)."""
    tiles_per_sheet = grid * grid
    max_tiles = max_sheets * tiles_per_sheet
    n = max(1, math.ceil(duration_s / interval_s)) if duration_s else 1
    if n > max_tiles:
        interval_s = duration_s / max_tiles
        n = max_tiles
    return interval_s, n


@functools.lru_cache(maxsize=8)
def _tile_mats(h: int, w: int, tile_h: int, tile_w: int,
               device: torch.device):
    """Resize matrices of one (source, tile) geometry on ``device``, built
    once, so the kernel's band form of each is built once too."""
    return mats_from_numpy(ladder_matrices((("tile", tile_h, tile_w, 0),),
                                           h, w), device)["tile"]


def generate_sprites(
    source_path: str | Path,
    out_dir: str | Path,
    *,
    interval_s: float | None = None,
    tile_w: int | None = None,
    tile_h: int | None = None,
    grid: int | None = None,
    max_sheets: int | None = None,
    quality: int = 75,
    progress_cb: ProgressFn | None = None,
    decode_chunk: int = 8,
    device="cuda",
) -> SpriteResult:
    """Decode sampled frames -> device resize -> JPEG sheets + VTT index.

    The JAX function's signature and defaults, plus ``device`` (default
    ``"cuda"``, which raises without CUDA)."""
    dev = resolve_device(device)
    interval_s = interval_s if interval_s is not None else config.SPRITE_INTERVAL_S
    tile_w = tile_w or config.SPRITE_TILE_W
    tile_h = tile_h or config.SPRITE_TILE_H
    grid = grid or config.SPRITE_GRID
    max_sheets = max_sheets or config.SPRITE_MAX_SHEETS
    tiles_per_sheet = grid * grid

    out_dir = Path(out_dir)
    sprite_dir = out_dir / "sprites"
    sprite_dir.mkdir(parents=True, exist_ok=True)

    src = open_source(source_path, dev)
    try:
        fps = src.fps_num / src.fps_den
        duration = src.frame_count / fps if fps else 0.0
        interval_s, n_tiles = plan_interval(
            duration, interval_s=interval_s, grid=grid, max_sheets=max_sheets)
        frame_idx = [
            min(int(round(k * interval_s * fps)), src.frame_count - 1)
            for k in range(n_tiles)
        ]
        n_sheets = math.ceil(n_tiles / tiles_per_sheet)

        # Sheet canvases in RGB, black background.
        sheet = np.zeros((grid * tile_h, grid * tile_w, 3), np.uint8)
        sheet_paths: list[str] = []
        cues: list[str] = []
        tiles_in_sheet = 0

        def flush_sheet() -> None:
            nonlocal tiles_in_sheet
            sheet_no = len(sheet_paths) + 1
            path = sprite_dir / f"sprite_{sheet_no:02d}.jpg"
            atomic_write_bytes(path, encode_jpeg_rgb(
                torch.as_tensor(sheet, device=dev), quality=quality))
            sheet_paths.append(str(path))
            sheet[:] = 0
            tiles_in_sheet = 0
            if progress_cb:
                progress_cb(sheet_no, n_sheets,
                            f"sprite sheet {sheet_no}/{n_sheets}")

        # Decode sampled frames in chunks; resize the whole chunk in one
        # batched device call (frames share source geometry).
        exhausted = False
        for c0 in range(0, n_tiles, decode_chunk):
            if exhausted:
                break
            idxs = frame_idx[c0:c0 + decode_chunk]
            ys, us, vs = [], [], []
            for fi in idxs:
                # Foreign sources have estimated frame counts: a sampled
                # index can overshoot the real stream end — stop there.
                item = next(src.read_batches(1, fi), None)
                if item is None:
                    exhausted = True
                    idxs = idxs[:len(ys)]
                    break
                by, bu, bv = item
                ys.append(by[0])
                us.append(bu[0])
                vs.append(bv[0])
            if not ys:
                break
            y, u, v = (torch.as_tensor(np.stack(p), device=dev)
                       for p in (ys, us, vs))
            mats = _tile_mats(y.shape[1], y.shape[2], tile_h, tile_w, dev)
            ty, tu, tv = resize_yuv420(y, u, v, mats)
            rgb = yuv420_to_rgb(ty, tu, tv, standard="bt709")
            # round half to even, as the JAX worker's np.round
            rgb = torch.clamp(torch.round(rgb * 255.0), 0, 255).to(
                torch.uint8).cpu().numpy()

            for j, k in enumerate(range(c0, c0 + len(idxs))):
                slot = k % tiles_per_sheet
                row, col = divmod(slot, grid)
                sheet[row * tile_h:(row + 1) * tile_h,
                      col * tile_w:(col + 1) * tile_w] = rgb[j]
                tiles_in_sheet += 1
                sheet_no = k // tiles_per_sheet + 1
                t0, t1 = k * interval_s, min((k + 1) * interval_s,
                                             duration or (k + 1) * interval_s)
                cues.append(
                    f"{_fmt_ts(t0)} --> {_fmt_ts(t1)}\n"
                    f"sprite_{sheet_no:02d}.jpg"
                    f"#xywh={col * tile_w},{row * tile_h},{tile_w},{tile_h}")
                if tiles_in_sheet == tiles_per_sheet:
                    flush_sheet()
        if tiles_in_sheet:
            flush_sheet()
    finally:
        src.close()

    vtt_path = sprite_dir / "sprites.vtt"
    atomic_write_text(vtt_path, "WEBVTT\n\n" + "\n\n".join(cues) + "\n")
    return SpriteResult(
        sheet_count=len(sheet_paths), tile_count=n_tiles,
        interval_s=interval_s, vtt_path=str(vtt_path),
        sheet_paths=sheet_paths)
