"""ops/transform.py and ops/bitproxy.py of the port against the JAX package.

Tolerance: the integer transform and quantiser are bit-exact (every
function, random int inputs, every QP 0-51, per-frame QP vectors).
``cost_proxy`` is a float32 log2 sum whose reduction order differs
between XLA and PyTorch: held to rtol 1e-6.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlog_tpu.ops import bitproxy as jbp
from vlog_tpu.ops import transform as jt
from vlog_tpu_torch.ops import bitproxy as tbp
from vlog_tpu_torch.ops import transform as tt

QPS = np.arange(52, dtype=np.int32)

# (name, input sampler (rng, shape) -> int array, block shape)
_CASES = {
    "quantize_intra": (lambda r, s: r.integers(-9180, 9181, s), (4, 4)),
    "quantize_inter": (lambda r, s: r.integers(-9180, 9181, s), (4, 4)),
    "dequantize": (lambda r, s: r.integers(-2000, 2001, s), (4, 4)),
    "quantize_luma_dc": (lambda r, s: r.integers(-65280, 65281, s), (4, 4)),
    "dequantize_luma_dc": (lambda r, s: r.integers(-2000, 2001, s), (4, 4)),
    "quantize_chroma_dc": (lambda r, s: r.integers(-16320, 16321, s), (2, 2)),
    "dequantize_chroma_dc": (lambda r, s: r.integers(-2000, 2001, s), (2, 2)),
}


def _fns(name):
    if name == "quantize_intra":
        return (lambda x, q: jt.quantize(x, qp=q, intra=True),
                lambda x, q: tt.quantize(x, qp=q, intra=True))
    if name == "quantize_inter":
        return (lambda x, q: jt.quantize(x, qp=q, intra=False),
                lambda x, q: tt.quantize(x, qp=q, intra=False))
    jf, tf = getattr(jt, name), getattr(tt, name)
    return (lambda x, q: jf(x, qp=q)), (lambda x, q: tf(x, qp=q))


@pytest.mark.parametrize("name", sorted(_CASES))
def test_qp_functions_bit_exact_every_qp(name):
    """One frame per QP 0..51: the port takes the (52,) QP vector aligned
    with the leading dim; the reference is vmapped over (block, qp)."""
    sampler, blk = _CASES[name]
    rng = np.random.default_rng(sorted(_CASES).index(name))
    x = sampler(rng, (52, 6) + blk).astype(np.int32)
    jfn, tfn = _fns(name)
    want = np.asarray(jax.vmap(jfn)(jnp.asarray(x), jnp.asarray(QPS)))
    got = tfn(torch.from_numpy(x), torch.from_numpy(QPS)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # scalar-QP form of the same call, at a few QPs
    for q in (0, 17, 51):
        np.testing.assert_array_equal(
            tfn(torch.from_numpy(x[q]), q).numpy(),
            np.asarray(jfn(jnp.asarray(x[q]), q)))


@pytest.mark.parametrize("name,lo,hi,shape", [
    ("core_transform", -255, 256, (7, 3, 4, 4)),
    ("inverse_core_transform", -40000, 40001, (7, 3, 4, 4)),
    ("hadamard4", -9180, 9181, (5, 4, 4)),
    ("hadamard2x2", -9180, 9181, (5, 2, 2)),
])
def test_transforms_bit_exact(name, lo, hi, shape):
    rng = np.random.default_rng(len(name))
    x = rng.integers(lo, hi, shape).astype(np.int32)
    want = np.asarray(getattr(jt, name)(jnp.asarray(x)))
    got = getattr(tt, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_block_tiling_round_trip_matches():
    rng = np.random.default_rng(3)
    plane = rng.integers(0, 256, (2, 16, 24)).astype(np.int32)
    want = np.asarray(jt.blocks_from_plane(jnp.asarray(plane)))
    got = tt.blocks_from_plane(torch.from_numpy(plane))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tt.plane_from_blocks(got).numpy(), plane)


def test_cost_proxy_matches_within_f32_tolerance():
    rng = np.random.default_rng(5)
    arrays = [rng.integers(-40, 41, (3, 4, 5, 4, 4)).astype(np.int16)
              * (rng.random((3, 4, 5, 4, 4)) < 0.3),
              rng.integers(-8, 9, (3, 2, 4, 5, 2, 2)).astype(np.int16)]
    want = np.asarray(jbp.cost_proxy(*map(jnp.asarray, arrays),
                                     batch_ndim=1))
    got = tbp.cost_proxy(*map(torch.from_numpy, arrays), batch_ndim=1)
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
