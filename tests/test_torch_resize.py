"""The ladder resize of the port against the JAX package, and the
kernel wrapper's device contract.

Tolerance: the plain PyTorch resize and the JAX one (the Pallas kernel
in interpret mode, and the XLA ``apply_resize_matrices``) are both
float32 products rounded half to even, summed in different orders: a
value within an ulp of x.5 may round the other way. Held to |diff| <= 1
with at most 0.1% of pixels differing (on these seeds: none).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlog_tpu.ops import pallas_ladder as jpl
from vlog_tpu.ops import resize as jrs
from vlog_tpu.parallel import ladder as jladder
from vlog_tpu_torch.ops import fused_resize
from vlog_tpu_torch.ops import resize as trs
from vlog_tpu_torch.parallel.ladder import ladder_matrices, mats_from_numpy

MAX_SHARE = 1e-3
_SRC = (64, 96)
# the raw-speed rungs, plus a rung whose chroma is 27 wide (odd)
_RUNGS = ((48, 64), (32, 48), (24, 32), (48, 54))


def _close(got: np.ndarray, want: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert diff.max() <= 1
    assert (diff > 0).mean() <= MAX_SHARE


def test_matrix_builders_are_copies():
    for (h, w) in _RUNGS:
        np.testing.assert_array_equal(trs.resample_matrix(_SRC[0], h),
                                      jrs.resample_matrix(_SRC[0], h))
        np.testing.assert_array_equal(trs.resample_matrix(_SRC[1], w),
                                      jrs.resample_matrix(_SRC[1], w))
    rungs = (("64p", 64, 96, 27),) + tuple(
        (f"{h}p{w}", h, w, 30) for h, w in _RUNGS)
    jm, tm = jladder.ladder_matrices(rungs, *_SRC), ladder_matrices(rungs, *_SRC)
    assert jm.keys() == tm.keys() and jm["64p"] is None and tm["64p"] is None
    for name in jm:
        if jm[name] is None:
            assert tm[name] is None
            continue
        (a, b), (c, d) = jm[name]
        (e, f), (g, k) = tm[name]
        for want, got in ((a, e), (b, f), (c, g), (d, k)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", _RUNGS)
def test_plain_resize_matches_pallas_and_xla(hw):
    h, w = hw
    rng = np.random.default_rng(h * 1000 + w)
    (a_h, a_w), (c_h, c_w) = trs.plan_ladder_matrices(*_SRC, (hw,))[hw]
    y = rng.integers(0, 256, (3,) + _SRC).astype(np.uint8)
    c = rng.integers(0, 256, (3, _SRC[0] // 2, _SRC[1] // 2)).astype(np.uint8)
    for plane, mh, mw in ((y, a_h, a_w), (c, c_h, c_w)):
        got = fused_resize.fused_resize_plane(
            torch.from_numpy(plane), torch.from_numpy(mh),
            torch.from_numpy(mw)).numpy()
        assert got.shape == plane.shape[:1] + (mh.shape[0], mw.shape[0])
        pallas = np.asarray(jpl.fused_resize_plane(
            jnp.asarray(plane), jnp.asarray(mh), jnp.asarray(mw)))
        xla = np.asarray(jrs.apply_resize_matrices(
            jnp.asarray(plane), jnp.asarray(mh), jnp.asarray(mw)))
        _close(got, pallas)
        _close(got, xla)


def _dense_from_band(first, taps, dst, src):
    groups, span, group = taps.shape
    dense = np.zeros((groups * group, src), np.float32)
    for g in range(groups):
        dense[g * group:(g + 1) * group, first[g]:first[g] + span] = taps[g].T
    return dense[:dst]


def _zero_row_matrix():
    a = trs.resample_matrix(96, 40).copy()
    a[[0, 17, 39]] = 0.0
    return a


def _dense_random_matrix():
    a = np.random.default_rng(5).random((24, 200)).astype(np.float32)
    return a / a.sum(1, keepdims=True)


# the twelve matrices of the 1080p ladder (Y and chroma of 720p, 480p,
# 360p), the three filters, upscales, a 4K source, a matrix with all-zero
# rows and a dense one (its band is the whole row)
_SLICE_PAIRS = [(s, d) for (sh, sw), (dh, dw) in
                [((1080, 1920), (720, 1280)), ((1080, 1920), (480, 854)),
                 ((1080, 1920), (360, 640))]
                for (s, d) in ((sh, dh), (sw, dw), (sh // 2, dh // 2),
                               (sw // 2, dw // 2))]
_BAND_CASES = (
    [pytest.param(lambda s=s, d=d: trs.resample_matrix(s, d), id=f"lanczos3-{s}-{d}")
     for s, d in _SLICE_PAIRS]
    + [pytest.param(lambda f=f: trs.resample_matrix(540, 180, f), id=f"{f}-540-180")
       for f in ("bilinear", "box")]
    + [pytest.param(lambda: trs.resample_matrix(37, 50), id="upscale-37-50"),
       pytest.param(lambda: trs.resample_matrix(53, 70, "bilinear"), id="upscale-53-70"),
       pytest.param(lambda: trs.resample_matrix(2160, 1080), id="4k-2160-1080"),
       pytest.param(lambda: trs.resample_matrix(3840, 1920), id="4k-3840-1920"),
       pytest.param(_zero_row_matrix, id="zero-rows"),
       pytest.param(_dense_random_matrix, id="dense-random")])


@pytest.mark.parametrize("group", [1, fused_resize.GROUP])
@pytest.mark.parametrize("make", _BAND_CASES)
def test_band_form_rebuilds_the_dense_matrix(make, group):
    a = make()
    first, taps = trs.band_form(a, group)
    groups = -(-a.shape[0] // group)
    assert first.dtype == np.int32 and taps.dtype == np.float32
    assert first.shape == (groups,) and taps.shape[::2] == (groups, group)
    assert np.array_equal(_dense_from_band(first, taps, *a.shape), a)


@pytest.mark.parametrize("make", _BAND_CASES)
def test_band_padding_indexes_in_range_sources(make):
    a = make()
    first, taps = trs.band_form(a, fused_resize.GROUP)
    span = taps.shape[1]
    assert (first >= 0).all() and (first + span <= a.shape[1]).all()
    # every nonzero of a row lies in its group's window
    for r in range(a.shape[0]):
        nz = np.flatnonzero(a[r])
        g = r // fused_resize.GROUP
        assert ((nz >= first[g]) & (nz < first[g] + span)).all()


def test_band_of_lanczos_is_a_narrow_band():
    """The 360p luma rows: 10-17 taps per row, one 26-wide window per
    group of four rows, against 1080 columns of the dense matrix."""
    first, taps = trs.band_form(trs.resample_matrix(1080, 360), fused_resize.GROUP)
    assert taps.shape == (90, 26, 4)
    assert (np.diff(first) >= 0).all()


@pytest.mark.parametrize("axis,tile,align", [(0, fused_resize.TILE_H, 1),
                                              (1, fused_resize.TILE_W,
                                               fused_resize.COL_ALIGN)])
@pytest.mark.parametrize("make", _BAND_CASES[::3])
def test_tile_windows_cover_every_group(make, axis, tile, align):
    a = torch.from_numpy(make())
    band = fused_resize._band_of(a, axis)
    first, win = band.first.numpy()[:band.groups], band.win.numpy()
    per_tile = tile // fused_resize.GROUP
    assert win.shape == (-(-a.shape[0] // tile), 2)
    # padded to whole tiles with zero taps
    assert band.first.shape[0] == win.shape[0] * per_tile == band.taps.shape[0]
    assert not band.taps[band.groups:].any()
    assert (win[:, 0] % align == 0).all() and (win[:, 0] >= 0).all()
    assert (win[:, 1] <= a.shape[1]).all()
    for t, (lo, hi) in enumerate(win):
        grp = first[t * per_tile:(t + 1) * per_tile]
        assert lo <= grp.min() and grp.max() + band.span <= hi
    assert band.widest == int((win[:, 1] - win[:, 0]).max())


def test_band_of_is_cached_per_tensor_and_rebuilt_after_a_write():
    a = torch.from_numpy(trs.resample_matrix(96, 40))
    first = fused_resize._band_of(a, 0)
    assert fused_resize._band_of(a, 0) is first
    assert fused_resize._band_of(a, 1) is not first
    a[3] = 0.0
    rebuilt = fused_resize._band_of(a, 0)
    assert rebuilt is not first
    assert np.array_equal(rebuilt.taps[0, :, 3].numpy(), np.zeros(rebuilt.span))
    key = (id(a), 0)
    del a, first, rebuilt
    assert key not in fused_resize._BANDS


def test_cpu_path_is_the_plain_version():
    """A CPU tensor takes apply_resize_matrices itself: same bytes, no
    launch counted, no band form built."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.integers(0, 256, (2, 540, 960)).astype(np.uint8))
    a_h = torch.from_numpy(trs.resample_matrix(540, 240))
    a_w = torch.from_numpy(trs.resample_matrix(960, 427))
    before, bands = fused_resize.launches, len(fused_resize._BANDS)
    got = fused_resize.fused_resize_plane(x, a_h, a_w)
    assert torch.equal(got, trs.apply_resize_matrices(x, a_h, a_w))
    assert fused_resize.launches == before and len(fused_resize._BANDS) == bands


def test_identity_rung_bypasses_the_kernel():
    rng = np.random.default_rng(9)
    y = torch.from_numpy(rng.integers(0, 256, (2,) + _SRC).astype(np.uint8))
    u = torch.from_numpy(rng.integers(0, 256, (2, 32, 48)).astype(np.uint8))
    before = fused_resize.launches
    out = fused_resize.resize_yuv420(y, u, u, None)
    assert out[0] is y and out[1] is u and fused_resize.launches == before
    jy = jpl.resize_yuv420_pallas(jnp.asarray(y.numpy()), jnp.asarray(u.numpy()),
                                  jnp.asarray(u.numpy()), None)[0]
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jy))


def test_mats_from_numpy_carries_the_jax_matrices():
    rungs = (("48p", 48, 64, 28), ("64p", 64, 96, 27))
    jm = jladder.ladder_matrices(rungs, *_SRC)
    tm = mats_from_numpy(jm, "cpu")
    assert tm["64p"] is None
    (a_h, a_w), (c_h, c_w) = tm["48p"]
    assert a_h.dtype == torch.float32 and a_h.shape == (48, 64)
    np.testing.assert_array_equal(c_w.numpy(), jm["48p"][1][1])


def test_cuda_path_raises_when_the_library_cannot_load(monkeypatch, tmp_path):
    """No silent fallback: a non-CPU tensor goes to the kernel, and a
    kernel library that cannot load raises instead of computing on the
    CPU (the loader points at a missing path here)."""
    monkeypatch.setattr(fused_resize, "_LIB", None)
    monkeypatch.setattr(fused_resize, "build_library",
                        lambda: tmp_path / "missing" / "libvt_fused_resize.so")
    x = torch.empty((1, 64, 96), dtype=torch.uint8, device="meta")
    a_h = torch.empty((48, 64), dtype=torch.float32, device="meta")
    a_w = torch.empty((64, 96), dtype=torch.float32, device="meta")
    before = fused_resize.launches
    with pytest.raises(OSError):
        fused_resize.fused_resize_plane(x, a_h, a_w)
    assert fused_resize.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from vlog_tpu_torch import config

    # the build directory (parallel/compile_cache.py), empty: a build runs
    monkeypatch.setattr(config, "COMPILE_CACHE_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused_resize.build_library()


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.parallel.ladder import ladder_chain_program

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ladder_chain_program((("48p", 48, 64, 28),), *_SRC, device="cuda")
