"""The port's chain ladder program against the JAX package's, without
the in-chain rate adaptation (tests/test_torch_ladder_rc.py has it).

Both run on the raw-speed ladder (64x96 source; 48/32/24-row rungs)
plus an identity rung, deblock on, 2 chains of 3 frames, search 2; the
JAX side runs the Pallas resize kernel in interpret mode. Tolerance:
keys, shapes and dtypes equal; integer outputs bit-exact where the
resized planes agree, and the test asserts that they agree on its seed;
``sse_y`` (a float32 sum) to rtol 1e-5.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from vlog_tpu.ops.pallas_ladder import resize_yuv420_pallas
from vlog_tpu.parallel import ladder as jladder
from vlog_tpu_torch.ops.fused_resize import resize_yuv420
from vlog_tpu_torch.parallel import ladder as tladder

SRC_H, SRC_W = 64, 96
RUNGS = (("64p", 64, 96, 26), ("48p", 48, 64, 28), ("32p", 32, 48, 29),
         ("24p", 24, 32, 30))
N, CLEN, SEARCH = 2, 3, 2
FLOAT_KEYS = ("sse_y", "cost")


def chains(seed: int = 0):
    """(N, CLEN, H, W) moving smooth content + noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SRC_H, 0:SRC_W].astype(np.float32)
    planes = {"y": [], "u": [], "v": []}
    for t in range(N * CLEN):
        y = (120 + 70 * np.sin((xx + 2 * t) / 8.0) * np.cos((yy + t) / 6.0)
             + rng.normal(0, 4, yy.shape))
        planes["y"].append(y)
        planes["u"].append(128 + 50 * np.sin((xx[::2, ::2] + t) / 5.0))
        planes["v"].append(128 + 50 * np.cos((yy[::2, ::2] + t) / 4.0))
    return tuple(np.clip(np.stack(planes[k]), 0, 255).astype(np.uint8)
                 .reshape((N, CLEN) + planes[k][0].shape) for k in "yuv")


def qps(seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {name: rng.integers(qp - 4, qp + 5, (N, CLEN)).astype(np.int32)
            for name, _, _, qp in RUNGS}


def assert_resize_agrees(jmats, y, u, v):
    """The precondition of bit-exactness: both packages' resized planes
    are identical on this seed."""
    flat = lambda p: p.reshape((-1,) + p.shape[2:])          # noqa: E731
    tmats = tladder.mats_from_numpy(jmats, "cpu")
    for name, *_ in RUNGS:
        want = resize_yuv420_pallas(*(jnp.asarray(flat(p)) for p in (y, u, v)),
                                    jmats[name])
        got = resize_yuv420(*(torch.from_numpy(flat(p)) for p in (y, u, v)),
                            tmats[name])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def run_both(rc_j=None, rc_t=None):
    y, u, v = chains()
    q = qps()
    jfn, jmats = jladder.ladder_chain_program(
        RUNGS, SRC_H, SRC_W, search=SEARCH, mesh=None, deblock=True,
        pallas=True)
    jmats = {k: None if m is None else tuple(tuple(np.asarray(a) for a in p)
                                              for p in m)
             for k, m in jmats.items()}
    assert_resize_agrees(jmats, y, u, v)
    want = jfn(y, u, v, jmats, q, rc_j)
    tfn, _ = tladder.ladder_chain_program(RUNGS, SRC_H, SRC_W, search=SEARCH,
                                          deblock=True, device="cpu")
    got = tfn(*(torch.from_numpy(p) for p in (y, u, v)),
              tladder.mats_from_numpy(jmats, "cpu"), q, rc_t)
    return got, want, q


def compare(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for k, b in want[name].items():
            a, b = got[name][k].numpy(), np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (name, k)
            if k in FLOAT_KEYS:
                np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=f"{name}/{k}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{name}/{k}")


def test_chain_program_matches_jax_without_rc():
    got, want, _ = run_both()
    compare(got, want)
    assert got["48p"]["p_luma"].shape == (N, CLEN - 1, 3, 4, 4, 4, 4, 4)
    assert np.any(got["32p"]["mv"].numpy() != 0)
