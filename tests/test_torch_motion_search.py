"""The HEVC motion search's two routes on the CPU: the plain stages of
``vlog_tpu_torch/codecs/hevc/core.py::_p_ctb_search`` against the JAX
package's (``vlog_tpu/codecs/hevc/jax_core.py``), and the guards of the
kernel's wrapper (``vlog_tpu_torch/ops/motion_search.py``): a CPU tensor
never reaches the kernel, any other tensor reaches it or raises, its
argument checks refuse what the kernel does not take, and a build
without ``nvcc`` raises. The kernel itself is held to the plain stages
on the card (``tests/test_torch_cuda.py``).

Seeded numpy inputs at 64x96, search 4 (edge content at the search's
edge, flat content where every offset ties). Exact: MVs and costs are
integers.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tests.test_torch_hevc_inter import SEARCH, content
from vlog_tpu_torch.codecs.h264.inter import edge_pad
from vlog_tpu_torch.codecs.hevc import core
from vlog_tpu_torch.ops import motion_search

I32 = torch.int32
PAD = SEARCH + 8


def _inputs(kind: str, device="cpu"):
    y = content(kind)[0]
    cur = torch.as_tensor(y[1:2]).to(I32)
    refp = edge_pad(torch.as_tensor(y[:1]).to(I32), PAD, PAD, PAD, PAD)
    return (cur.to(device), refp.to(device),
            core._hfiltered_planes(refp, core._LTAPS).to(device))


@functools.lru_cache(maxsize=None)
def _jax_search(n: int):
    import jax

    from vlog_tpu.codecs.hevc import jax_core

    return jax.jit(functools.partial(jax_core._p_ctb_search, search=SEARCH,
                                     pad=PAD, n=n))


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("kind", ["moving", "edge", "flat"])
def test_cpu_search_takes_the_plain_stages_and_equals_jax(kind, n):
    from vlog_tpu.codecs.hevc import jax_core

    cur, refp, hplanes = _inputs(kind)
    before = motion_search.launches
    mv, cost = core._p_ctb_search(cur, refp, hplanes, search=SEARCH, pad=PAD,
                                  n=n)
    assert motion_search.launches == before
    assert mv.dtype == I32 and cost.dtype == I32
    assert mv.shape == (1, 64 // n, 96 // n, 2) and cost.shape == mv.shape[:3]
    jhp = jax_core._hfiltered_planes(refp[0].numpy(), jax_core._LTAPS)
    want_mv, want_cost = _jax_search(n)(cur[0].numpy(), refp[0].numpy(), jhp)
    np.testing.assert_array_equal(mv[0].numpy(), np.asarray(want_mv))
    np.testing.assert_array_equal(cost[0].numpy(), np.asarray(want_cost))
    if kind == "flat":
        assert not mv.any()                     # every tie keeps (0, 0)
    if kind == "edge":
        assert np.abs(mv.numpy()).max() >= 4 * SEARCH


def test_non_cpu_tensors_reach_the_kernel_wrapper_or_raise():
    """No fallback: a tensor on another device than the CPU goes to the
    kernel's wrapper, which refuses what is not on a CUDA device."""
    cur, refp, hplanes = _inputs("moving", device="meta")
    before = motion_search.launches
    with pytest.raises(ValueError, match="not CUDA"):
        core._p_ctb_search(cur, refp, hplanes, search=SEARCH, pad=PAD)
    assert motion_search.launches == before


def _bad(case: str):
    cur, refp, hplanes = _inputs("moving")
    kw = {"search": SEARCH, "pad": PAD, "lam": 2, "n": 32}
    if case == "dtype":
        cur = cur.to(torch.int64)
    elif case == "uint8":
        refp = refp.to(torch.uint8)
    elif case == "rank":
        cur = cur[0]
    elif case == "refp_shape":
        refp = refp[:, 1:]
    elif case == "hplanes_shape":
        hplanes = hplanes[:, :3]
    elif case == "batch":
        hplanes = torch.cat([hplanes, hplanes])
    elif case == "grid":
        cur, refp, hplanes = cur[:, :48], refp[:, :48 + 2 * PAD], \
            hplanes[:, :, :48 + 2 * PAD]
    elif case == "contiguous":
        hplanes = hplanes.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "n":
        kw["n"] = 8
    elif case == "search_low":
        kw["search"] = 0
    elif case == "search_high":
        kw.update(search=33, pad=33 + 8)
    elif case == "search_float":
        kw["search"] = 4.0
    elif case == "lam":
        kw["lam"] = -1
    elif case == "pad":     # shapes consistent with the smaller pad
        kw["pad"] = pad = SEARCH + 3
        refp = edge_pad(cur.clone(), pad, pad, pad, pad)
        hplanes = core._hfiltered_planes(refp, core._LTAPS)
    return (cur, refp, hplanes), kw


@pytest.mark.parametrize("case,match", [
    ("dtype", "int32"), ("uint8", "int32"), ("rank", r"\(B, H, W\)"),
    ("refp_shape", "refp"), ("hplanes_shape", "hplanes"),
    ("batch", "hplanes"), ("grid", "whole grid"),
    ("contiguous", "contiguous"), ("n", "block size"),
    ("search_low", "search"), ("search_high", "search"),
    ("search_float", "search"), ("lam", "lam"), ("pad", "pad"),
    ("cpu", "not CUDA"),
])
def test_wrapper_refuses_what_the_kernel_does_not_take(case, match):
    args, kw = _bad(case)
    before = motion_search.launches
    with pytest.raises(ValueError, match=match):
        motion_search.p_ctb_search(*args, **kw)
    assert motion_search.launches == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from vlog_tpu_torch import config

    # an empty build directory (parallel/compile_cache.py): a build runs
    monkeypatch.setattr(config, "COMPILE_CACHE_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(motion_search, "_LIB", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        motion_search.load_library()
    assert motion_search._LIB is None


def test_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    from vlog_tpu_torch import config

    monkeypatch.setattr(config, "COMPILE_CACHE_DIR", str(tmp_path / "build"))
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(fake.parent))
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*no sm_90a here"):
        motion_search.build_library()
    assert not list((tmp_path / "build").glob("libvt_hevc_motion_search*"))
