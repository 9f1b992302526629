"""The port's sprite worker (``vlog_tpu_torch/worker/sprites.py``, CPU
path: the plain resize, colour conversion and JPEG DCT in PyTorch)
against the JAX package's ``vlog_tpu/worker/sprites.py``.

Sources: a seeded synthetic Y4M, an all-intra CAVLC MP4 from the JAX
encoder, and JaxBackend's I+P CABAC output remuxed into an MP4. The
default tiles (160x90) and grid (10x10) make the 900x1600 sheet whose
colour conversion is compared here (ROADMAP Queue C item 6).

Tolerance: the VTT index and the result fields are identical; the tile
planes (the sampled frames resized to the tile) are within the resize's
bound (|diff| <= 1 on at most 0.1% of pixels, Queue C item 1); where
the tile planes agree, the sheet JPEG bytes are identical. On the I+P
MP4, whose sampled frames lie mid-GOP, the port's sheets equal its
sheets of a Y4M of the sequential decode, and its reads continue
forward: the whole run decodes each frame once.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from vlog_tpu.worker import sprites as jspr
from vlog_tpu_torch.worker import sprites as tspr

from tests.fixtures.media import make_y4m
from tests.test_torch_backend import one_torch_thread  # noqa: F401
from tests.test_torch_mp4 import intra_mp4, ip_mp4

MAX_ABS, MAX_SHARE = 1, 1e-3


@pytest.mark.parametrize("duration,interval,grid,sheets", [
    (0.0, 10.0, 10, 20), (95.0, 10.0, 10, 20), (30_000.0, 10.0, 10, 20),
    (7.3, 0.25, 2, 1), (3600.0 * 2 + 1.5, 5.0, 3, 4)])
def test_plan_interval_and_timestamps_match_jax(duration, interval, grid,
                                                sheets):
    kw = dict(interval_s=interval, grid=grid, max_sheets=sheets)
    got = tspr.plan_interval(duration, **kw)
    assert got == jspr.plan_interval(duration, **kw)
    for t in (0.0, got[0], 59.9996, 3599.9999, 7261.25, duration):
        assert tspr._fmt_ts(t) == jspr._fmt_ts(t)


def _sampled(path: Path, interval: float, tiles: int):
    """The frames generate_sprites samples, from a sequential decode."""
    from vlog_tpu_torch.backends.source import open_source

    with open_source(path, "cpu") as src:
        ys, us, vs = next(src.read_batches(src.frame_count))
        fps = src.fps_num / src.fps_den
        idx = [min(int(round(k * interval * fps)), src.frame_count - 1)
               for k in range(tiles)]
    return ys[idx], us[idx], vs[idx]


def _tiles_within_bound(frames, tile_h=90, tile_w=160) -> bool:
    """JAX's tile resize against the port's plain one on the same
    frames; True when every plane is identical."""
    from vlog_tpu.ops.resize import resize_yuv420 as jresize
    from vlog_tpu_torch.ops.fused_resize import resize_yuv420

    want = jresize(*frames, tile_h, tile_w)
    got = resize_yuv420(*(torch.as_tensor(p) for p in frames),
                        tspr._tile_mats(frames[0].shape[1], frames[0].shape[2],
                                        tile_h, tile_w, torch.device("cpu")))
    same = True
    for w, g in zip(want, got):
        diff = np.abs(np.asarray(w).astype(np.int16) - g.numpy().astype(np.int16))
        assert diff.max() <= MAX_ABS and (diff > 0).sum() <= MAX_SHARE * diff.size
        same &= not diff.any()
    return same


def _both(path: Path, tmp_path: Path, **kw):
    jres = jspr.generate_sprites(path, tmp_path / "jax", **kw)
    tres = tspr.generate_sprites(path, tmp_path / "torch", device="cpu", **kw)
    for f in ("sheet_count", "tile_count", "interval_s"):
        assert getattr(tres, f) == getattr(jres, f), f
    assert [Path(p).name for p in tres.sheet_paths] == \
        [Path(p).name for p in jres.sheet_paths]
    assert Path(tres.vtt_path).read_bytes() == Path(jres.vtt_path).read_bytes()
    assert not list((tmp_path / "torch" / "sprites").glob("*.tmp"))
    return jres, tres


def _sheets_equal(jres, tres) -> None:
    for jp, tp in zip(jres.sheet_paths, tres.sheet_paths):
        assert Path(tp).read_bytes() == Path(jp).read_bytes(), Path(tp).name


@pytest.mark.parametrize("interval", [0.1, 0.35])
def test_sprites_of_a_y4m_match_jax(tmp_path, interval):
    """Default tiles and grid: one 900x1600 sheet; 10 tiles (a full
    decode chunk of 8 and a partial one) or 3."""
    src = make_y4m(tmp_path / "s.y4m", n_frames=24, width=128, height=96,
                   fps=24, seed=3)
    jres, tres = _both(src, tmp_path, interval_s=interval)
    assert tres.sheet_count == 1
    if _tiles_within_bound(_sampled(src, tres.interval_s, tres.tile_count)):
        _sheets_equal(jres, tres)


def test_sprites_of_an_intra_mp4_match_jax(tmp_path):
    src = intra_mp4(tmp_path, n_frames=12)
    jres, tres = _both(src, tmp_path, interval_s=0.2, grid=2, max_sheets=3)
    assert (tres.tile_count, tres.sheet_count) == (6, 2)
    if _tiles_within_bound(_sampled(src, tres.interval_s, tres.tile_count)):
        _sheets_equal(jres, tres)


def test_sprites_of_an_ip_mp4_read_forward(tmp_path, monkeypatch):
    """Tiles at frames 0, 3, ..., 18 of a 20-frame I+P MP4 (IDRs at 0
    and 10): the sheets are those of the sequential decode, and every
    frame up to 18 is decoded exactly once."""
    from vlog_tpu_torch.backends import source as tsrc
    from vlog_tpu_torch.media.y4m import write_y4m

    path = ip_mp4(tmp_path, n_frames=20)
    opened = []

    def spy(*a, **k):
        opened.append(tsrc.open_source(*a, **k))
        return opened[-1]

    monkeypatch.setattr(tspr, "open_source", spy)
    kw = dict(interval_s=0.3, grid=3, max_sheets=2)
    jres, tres = _both(path, tmp_path, **kw)
    assert tres.tile_count == 7
    assert opened[0].frames_decoded == 19

    with tsrc.open_source(path, "cpu") as src:
        ys, us, vs = next(src.read_batches(20))
    y4m = tmp_path / "seq.y4m"
    write_y4m(y4m, list(zip(ys, us, vs)), fps_num=10, fps_den=1)
    seq = tspr.generate_sprites(y4m, tmp_path / "seq", device="cpu", **kw)
    _sheets_equal(seq, tres)
    assert Path(seq.vtt_path).read_bytes() == Path(tres.vtt_path).read_bytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_sheet_colour_and_jpeg_match_jax_at_900x1600(seed):
    """The stages after the resize on identical tile planes: BT.709 RGB
    rounded half to even, 100 tiles placed on the 900x1600 sheet, the
    JPEG at quality 75. Any byte that moves is reported with its
    position."""
    from vlog_tpu.codecs.jpeg import encode_jpeg_rgb as jjpeg
    from vlog_tpu.ops.colorspace import yuv420_to_rgb as jrgb
    from vlog_tpu_torch.codecs.jpeg import encode_jpeg_rgb
    from vlog_tpu_torch.ops.colorspace import yuv420_to_rgb

    rng = np.random.default_rng(seed)
    n, th, tw = 100, 90, 160
    y = rng.integers(0, 256, (n, th, tw), dtype=np.uint8)
    u = rng.integers(0, 256, (n, th // 2, tw // 2), dtype=np.uint8)
    v = rng.integers(0, 256, (n, th // 2, tw // 2), dtype=np.uint8)
    want = np.clip(np.round(np.asarray(jrgb(y, u, v, standard="bt709"))
                            * 255.0), 0, 255).astype(np.uint8)
    got = torch.clamp(torch.round(yuv420_to_rgb(
        *(torch.as_tensor(p) for p in (y, u, v)), standard="bt709") * 255.0),
        0, 255).to(torch.uint8).numpy()
    moved = np.argwhere(got != want)
    assert moved.size == 0, f"RGB differs at (tile, row, col, ch) {moved[:5].tolist()}"

    def sheet(rgb):
        return rgb.reshape(10, 10, th, tw, 3).transpose(0, 2, 1, 3, 4) \
            .reshape(10 * th, 10 * tw, 3)

    jb = jjpeg(sheet(want), quality=75)
    tb = encode_jpeg_rgb(torch.as_tensor(sheet(got)), quality=75)
    first = next((i for i, (a, b) in enumerate(zip(jb, tb)) if a != b), None)
    assert tb == jb, f"JPEG bytes differ from byte {first} ({len(tb)} vs {len(jb)})"
