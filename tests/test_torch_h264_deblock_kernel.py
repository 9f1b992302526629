"""The H.264 deblocking filter's two routes on the CPU: the plain
wavefront of ``vlog_tpu_torch/codecs/h264/deblock.py::deblock_frame``
against the JAX package's (``vlog_tpu/codecs/h264/deblock.py``), and the
guards of the kernel's wrapper (``vlog_tpu_torch/ops/h264_deblock.py``):
a CPU tensor never reaches the kernel, any other tensor reaches it or
raises, its argument checks refuse what the kernel does not take, a
build without ``nvcc`` raises, and the kernel source's constant tables
are the plain version's. The kernel itself is held to the plain
wavefront on the card (``tests/test_torch_cuda.py``).

Seeded noisy content around a per-frame level at 48x64 (3 x 4
macroblocks), so that every filter branch runs. Exact: integer planes.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vlog_tpu_torch.codecs.h264 import deblock, encoder
from vlog_tpu_torch.ops import h264_deblock

N, H, W = 4, 48, 64
MBH, MBW = H // 16, W // 16
QPS = [18, 30, 40, 51]


def _inputs(kind: str, device="cpu", seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(40, 216, (N, 1, 1))

    def plane(h, w, spread):
        a = np.clip(base + rng.integers(-spread, spread + 1, (N, h, w)), 0, 255)
        return torch.as_tensor(a).to(torch.uint8).to(device)

    planes = (plane(H, W, 10), plane(H // 2, W // 2, 5),
              plane(H // 2, W // 2, 5))
    if kind == "intra":
        bs_v, bs_h = deblock.intra_bs(MBH, MBW, device)
    elif kind == "p":
        nz4 = torch.as_tensor(rng.random((N, 4 * MBH, 4 * MBW)) < 0.3,
                              dtype=torch.int32)
        mv = torch.as_tensor(rng.integers(-9, 10, (N, MBH, MBW, 2)),
                             dtype=torch.int32)
        bs_v, bs_h = (b.to(device) for b in deblock.p_bs(nz4, mv))
    else:                                   # "random": bS 0-4 anywhere
        bs_v, bs_h = (torch.as_tensor(rng.integers(0, 5, (N, MBH, MBW, 4, 4)),
                                      dtype=torch.int32, device=device)
                      for _ in range(2))
    qp = torch.tensor(QPS, dtype=torch.int32, device=device)
    return planes, qp, bs_v, bs_h


@pytest.mark.parametrize("kind", ["intra", "p", "random"])
def test_cpu_takes_the_plain_wavefront_and_equals_jax(kind):
    from vlog_tpu.codecs.h264 import deblock as jdb

    planes, qp, bs_v, bs_h = _inputs(kind)
    before = h264_deblock.launches
    got = deblock.deblock_frame(*planes, qp=qp, bs_v=bs_v, bs_h=bs_h)
    assert h264_deblock.launches == before
    assert all(g.dtype == torch.int32 for g in got)
    changed = 0
    for i in range(N):
        bv = (bs_v if bs_v.dim() == 4 else bs_v[i]).numpy()
        bh = (bs_h if bs_h.dim() == 4 else bs_h[i]).numpy()
        want = jdb.deblock_frame(*(p[i].numpy() for p in planes), qp=QPS[i],
                                 bs_v=bv, bs_h=bh)
        for g, w, p in zip(got, want, planes):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
            changed += int((np.asarray(w) != p[i].numpy()).sum())
    assert changed > 0


def test_non_cpu_tensors_reach_the_kernel_wrapper_or_raise():
    """No fallback: a tensor on another device than the CPU goes to the
    kernel's wrapper, which refuses what is not on a CUDA device."""
    planes, qp, bs_v, bs_h = _inputs("p", device="meta")
    before = h264_deblock.launches
    with pytest.raises(ValueError, match="not CUDA"):
        deblock.deblock_frame(*planes, qp=qp, bs_v=bs_v, bs_h=bs_h)
    with pytest.raises(ValueError, match="not CUDA"):
        deblock.deblock_frame(*planes, qp=30, bs_v=bs_v[0], bs_h=bs_h[0])
    assert h264_deblock.launches == before


def _bad(case: str):
    planes, qp, bs_v, bs_h = _inputs("p")
    y, u, v = planes
    if case == "dtype":
        y, u, v = (p.to(torch.int32) for p in planes)
    elif case == "mixed_dtypes":
        u = u.to(torch.int32)
    elif case == "rank":
        y = y[0]
    elif case == "grid":                    # 40 rows: no whole macroblocks
        y, u, v = y[:, :40], u[:, :20], v[:, :20]
    elif case == "chroma_shape":
        v = v[:, :, :16]
    elif case == "planes_disagree":         # chroma of a 2-MB-high frame
        u, v = u[:, :16], v[:, :16]
    elif case == "bs_shape":
        bs_v = bs_v[:, :, :, :3]
    elif case == "bs_grid":
        bs_h = bs_h[:, :2]
    elif case == "bs_batch":
        bs_v = bs_v[:2]
    elif case == "bs_dtype":
        bs_h = bs_h.to(torch.int64)
    elif case == "qp_length":
        qp = qp[:3]
    elif case == "qp_dtype":
        qp = qp.to(torch.int64)
    elif case == "contiguous":
        y = y.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "bs_contiguous":
        bs_v = bs_v.transpose(3, 4)
    return (y, u, v), {"qp": qp, "bs_v": bs_v, "bs_h": bs_h}


@pytest.mark.parametrize("case,match", [
    ("dtype", "not uint8"), ("mixed_dtypes", "not uint8"),
    ("rank", r"\(n, H, W\)"), ("grid", "whole grid"),
    ("chroma_shape", "chroma"), ("planes_disagree", "chroma"),
    ("bs_shape", "bs_v"), ("bs_grid", "bs_h"), ("bs_batch", "bs_v"),
    ("bs_dtype", "bs_h .*not int32"), ("qp_length", "qp"),
    ("qp_dtype", "qp"), ("contiguous", "contiguous"),
    ("bs_contiguous", "contiguous"), ("cpu", "not CUDA"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    args, kw = _bad(case)
    before = h264_deblock.launches
    with pytest.raises(ValueError, match=match):
        h264_deblock.deblock(*args, **kw)
    assert h264_deblock.launches == before


def _source_table(name: str) -> np.ndarray:
    src = (Path(h264_deblock.__file__).resolve().parent.parent / "csrc"
           / "h264_deblock.cu").read_text()
    m = re.search(r"#define VT_%s \{(.*?)\}\n" % name, src, re.S)
    assert m, name
    return np.array([int(x) for x in re.findall(r"\d+", m.group(1))], np.int32)


def test_kernel_tables_are_the_plain_versions():
    """Tables 8-16, 8-17 and 8-15 as the kernel source holds them in
    constant memory (the same initialisers the library returns to the
    wrapper, which compares them again at load)."""
    np.testing.assert_array_equal(_source_table("ALPHA"), deblock.ALPHA)
    np.testing.assert_array_equal(_source_table("BETA"), deblock.BETA)
    np.testing.assert_array_equal(_source_table("TC0"), deblock.TC0.ravel())
    np.testing.assert_array_equal(_source_table("CHROMA_QP"),
                                  encoder._CHROMA_QP)
    assert h264_deblock._tables().shape == (6 * 52,)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from vlog_tpu_torch import config

    # an empty build directory (parallel/compile_cache.py): a build runs
    monkeypatch.setattr(config, "COMPILE_CACHE_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(h264_deblock, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        h264_deblock.load_library()
    assert h264_deblock._LIB is None


def test_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    from vlog_tpu_torch import config

    monkeypatch.setattr(config, "COMPILE_CACHE_DIR", str(tmp_path / "build"))
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*no sm_90a here"):
        h264_deblock.build_library()
    assert not list((tmp_path / "build").glob("libvt_h264_deblock*"))
