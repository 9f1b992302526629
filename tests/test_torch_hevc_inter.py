"""The port's HEVC P frames, I+P chains and fused ladder against the JAX
package (``vlog_tpu/codecs/hevc/jax_core.py``,
``vlog_tpu/parallel/hevc_ladder.py``) on the CPU.

Seeded numpy inputs at 64x96 and 64x128, chains of 3-4 frames, search
radius 4. Tolerance: exact for every integer output (levels, MVs,
partition codes, reconstructions, ``qp_eff``); the float32 ``cost`` and
SSE sums within a relative 1e-5 (ROADMAP Queue C item 2: float32 sums
in another order). The contents cover the motion search's tie order
(flat frames, where every offset ties), motion at the search edge,
split motion that the partitioned mode decision takes, and chains at
different QPs in one batch.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from tests.test_h264_p import moving_frames
from tests.test_torch_backend import one_torch_thread  # noqa: F401

I32 = torch.int32
SEARCH = 4
RTOL = 1e-5


def _t(a, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _stack(frames):
    return tuple(np.stack([f[k] for f in frames]) for k in range(3))


def split_frames(n=4, h=64, w=128, seed=3):
    """Three bands panning opposite ways: 2NxN CTBs win."""
    rng = np.random.default_rng(seed)
    world = np.clip(100 + 60 * np.sin(np.arange(w * 3)[None, :] / 19.0)
                    * np.cos(np.arange(h)[:, None] / 11.0)
                    + rng.normal(0, 2, (h, w * 3)), 0, 255).astype(np.uint8)
    out = []
    for t in range(n):
        y = np.empty((h, w), np.uint8)
        y[:16] = world[:16, 64 + 3 * t:64 + 3 * t + w]
        y[16:48] = world[16:48, 64 - 3 * t:64 - 3 * t + w]
        y[48:] = world[48:, 64 + 3 * t:64 + 3 * t + w]
        out.append((y, np.full((h // 2, w // 2), 120, np.uint8),
                    np.full((h // 2, w // 2), 130, np.uint8)))
    return _stack(out)


def content(kind: str):
    """(y, u, v) stacks of 4 frames, (T, H, W) uint8."""
    if kind == "moving":
        return _stack(moving_frames(4, 64, 96))
    if kind == "edge":       # 4 pels a frame: the search's edge offset
        return _stack(moving_frames(4, 64, 96, seed=2, dx=SEARCH, dy=-SEARCH))
    if kind == "split":
        return split_frames()
    if kind == "flat":       # every offset ties
        return tuple(np.full((4, 64 // s, 96 // s), c, np.uint8)
                     for s, c in ((1, 77), (2, 128), (2, 90)))
    raise ValueError(kind)


@functools.lru_cache(maxsize=None)
def jax_p_frame():
    """The reference's ``encode_p_frame_dsp`` under ``jax.jit`` (eager
    dispatch of its scans is much slower than one compile)."""
    import jax

    from vlog_tpu.codecs.hevc.jax_core import encode_p_frame_dsp

    return jax.jit(encode_p_frame_dsp,
                   static_argnames=("search", "partitions", "deblock"))


def assert_p_equal(want, got, i=0):
    """One JAX ``encode_p_frame_dsp`` result against row ``i`` of the
    port's batched result."""
    for a, b in zip(want[0], got[0]):
        np.testing.assert_array_equal(np.asarray(a), b[i].numpy())
    if want[1] is None:
        assert got[1] is None
    else:
        for a, b in zip(want[1], got[1]):
            np.testing.assert_array_equal(np.asarray(a), b[i].numpy())
    for k in (2, 3):
        np.testing.assert_array_equal(np.asarray(want[k]), got[k][i].numpy())
    for a, b in zip(want[4], got[4]):
        np.testing.assert_array_equal(np.asarray(a), b[i].numpy())


@pytest.mark.parametrize("partitions", [False, True])
@pytest.mark.parametrize("kind", ["moving", "edge", "split", "flat"])
def test_encode_p_frame_dsp_equals_jax(kind, partitions):
    from vlog_tpu_torch.codecs.hevc.core import encode_p_frame_dsp as tfn

    jfn = jax_p_frame()

    y, u, v = content(kind)
    want = jfn(y[1], u[1], v[1], y[0], u[0], v[0], 30, search=SEARCH,
               partitions=partitions, deblock=True)
    got = tfn(*(_t(p[k:k + 1]) for k in (1, 0) for p in (y, u, v)),
              _t([30], I32), search=SEARCH, partitions=partitions,
              deblock=True)
    assert_p_equal(want, got)
    mv = got[3].numpy()
    if kind == "flat":
        assert not mv.any()                   # ties keep (0, 0)
    if kind == "edge":
        assert np.abs(mv).max() >= 4 * SEARCH  # reached the search edge
    if kind == "split" and partitions:
        assert (got[2].numpy() != 0).any()     # two-part CTBs chosen


def test_encode_p_frame_dsp_two_chains_two_qps():
    """Two rows of one batch at different QPs and contents equal two
    reference calls."""
    from vlog_tpu_torch.codecs.hevc.core import encode_p_frame_dsp as tfn

    jfn = jax_p_frame()

    a, b = content("moving"), content("edge")
    qps = (22, 41)
    got = tfn(*(_t(np.stack([a[k][t], b[k][t]])) for t in (1, 0)
                for k in range(3)),
              _t(qps, I32), search=SEARCH, partitions=True, deblock=True)
    for i, (c, qp) in enumerate(zip((a, b), qps)):
        want = jfn(c[0][1], c[1][1], c[2][1], c[0][0], c[1][0], c[2][0], qp,
                   search=SEARCH, partitions=True, deblock=True)
        assert_p_equal(want, got, i)


def _chain_both(chains, qp_i, qp_p, partitions, deblock, rc):
    """Each chain through the JAX ``encode_chain_dsp``, all of them
    through the port's in one batch."""
    from vlog_tpu.codecs.hevc.jax_core import encode_chain_dsp as jfn
    from vlog_tpu_torch.codecs.hevc.core import encode_chain_dsp as tfn

    want = [jfn(*c, SEARCH, np.int32(qp_i[i]), np.asarray(qp_p[i], np.int32),
                partitions, deblock, rc) for i, c in enumerate(chains)]
    got = tfn(*(_t(np.stack([c[k] for c in chains])) for k in range(3)),
              SEARCH, _t(qp_i, I32), _t(qp_p, I32), partitions, deblock, rc)
    return want, got


@pytest.mark.parametrize("rc", [None, "rc"])
@pytest.mark.parametrize("partitions", [False, True])
def test_encode_chain_dsp_equals_jax(partitions, rc):
    """I + 3 P frames, two chains at different QPs in one batch, deblock
    on; with ``rc`` the device cascade moves the P frames' QPs."""
    y, u, v = content("split")                  # cropped to 64x96
    chains = [content("moving"), (y[..., :96], u[..., :48], v[..., :48])]
    rcp = (None if rc is None else
           {"budget": np.float32(150.0), "alpha": np.float32(0.9)})
    want, got = _chain_both(chains, [26, 36], [[28, 29, 30], [38, 37, 38]],
                            partitions, True, rcp)
    (gi, grec), (g32, g16, gparts, gmvs, gprec) = got[0], got[1]
    for i, w in enumerate(want):
        (wi, wrec), (w32, w16, wparts, wmvs, wprec) = w[0], w[1]
        for a, b in zip(wi + wrec, gi + grec):
            np.testing.assert_array_equal(np.asarray(a), b[i].numpy())
        for a, b in zip(w32 + wprec, g32 + gprec):
            np.testing.assert_array_equal(np.asarray(a), b[i].numpy())
        if partitions:
            for a, b in zip(w16, g16):
                np.testing.assert_array_equal(np.asarray(a), b[i].numpy())
        else:
            assert w16 is None and g16 is None
        np.testing.assert_array_equal(np.asarray(wparts), gparts[i].numpy())
        np.testing.assert_array_equal(np.asarray(wmvs), gmvs[i].numpy())
        if rc is not None:
            np.testing.assert_array_equal(np.asarray(w[2]["qp_eff"]),
                                          got[2]["qp_eff"][i].numpy())
            np.testing.assert_allclose(got[2]["cost"][i].numpy(),
                                       np.asarray(w[2]["cost"]), rtol=RTOL)
    if rc is not None:
        # the cascade moved QPs off the plan
        assert (got[2]["qp_eff"].numpy() != np.array([[28, 29, 30],
                                                      [38, 37, 38]])).any()


def test_encode_chain_dsp_intra_only():
    """A one-frame chain is its I frame (the ``gop_mode="intra"`` shape)."""
    want, got = _chain_both([tuple(p[:1] for p in content("moving"))],
                            [30], [[30]], False, True,
                            {"budget": np.float32(300.0),
                             "alpha": np.float32(0.0)})
    assert got[1] == (None,) * 5 and want[0][1] == (None,) * 5
    for a, b in zip(want[0][0][0] + want[0][0][1], got[0][0] + got[0][1]):
        np.testing.assert_array_equal(np.asarray(a), b[0].numpy())
    assert got[2]["qp_eff"].shape == (1, 0)
    np.testing.assert_allclose(got[2]["cost"][0].numpy(),
                               np.asarray(want[0][2]["cost"]), rtol=RTOL)


# ---------------------------------------------------------------- the ladder

SRC_H, SRC_W = 64, 96
RUNGS = (("64p", 64, 96, 30), ("48p", 48, 72, 32))


def ladder_chains(seed: int = 11):
    """(2 chains, 3 frames) of moving content + noise."""
    frames = moving_frames(6, SRC_H, SRC_W, seed=seed, dx=2, dy=1)
    return tuple(p.reshape((2, 3) + p.shape[1:]) for p in _stack(frames))


@pytest.mark.parametrize("clen", [1, 3])
def test_hevc_ladder_program_equals_jax(clen):
    """The fused ladder (an identity rung and a scaled one, the JAX side
    through the Pallas kernel in interpret mode): every output key
    exact, ``sse_y`` and ``cost`` within RTOL."""
    from vlog_tpu.parallel import hevc_ladder as jl
    from vlog_tpu_torch.parallel import hevc_ladder as tl
    from vlog_tpu_torch.parallel.ladder import mats_from_numpy

    y, u, v = (p[:, :clen] for p in ladder_chains())
    rng = np.random.default_rng(2)
    qps = {n: rng.integers(q - 3, q + 4, (2, clen)).astype(np.int32)
           for n, _, _, q in RUNGS}
    rc = {n: {"budget": np.float32(120.0), "alpha": np.float32(a)}
          for (n, *_), a in zip(RUNGS, (0.8, 0.0))}
    jfn, jmats = jl.hevc_chain_ladder_program(  # slowlane-ok: 2 tiny rungs
        RUNGS, SRC_H, SRC_W, search=SEARCH, deblock=True, pallas=True)
    jmats = {k: None if m is None else tuple(tuple(np.asarray(a) for a in p)
                                              for p in m)
             for k, m in jmats.items()}
    want = jfn(y, u, v, jmats, qps, rc)
    tfn, _ = tl.hevc_chain_ladder_program(  # slowlane-ok: 2 tiny rungs
        RUNGS, SRC_H, SRC_W, search=SEARCH, deblock=True, device="cpu")
    got = tfn(*(torch.from_numpy(p) for p in (y, u, v)),
              mats_from_numpy(jmats, "cpu"), qps, rc)
    for name, *_ in RUNGS:
        assert set(got[name]) == set(want[name])
        for k, w in want[name].items():
            g = got[name][k].numpy()
            assert g.shape == np.asarray(w).shape, (name, k)
            if k in ("sse_y", "cost"):
                np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL)
            else:
                assert g.dtype == np.asarray(w).dtype, (name, k)
                np.testing.assert_array_equal(g, np.asarray(w), err_msg=k)
