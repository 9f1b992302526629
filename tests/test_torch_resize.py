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
    monkeypatch.setattr(fused_resize, "_BUILD_DIR", tmp_path / "build")
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
