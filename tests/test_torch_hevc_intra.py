"""The port's HEVC host copies, intra DSP and deblocking filter against the
JAX package (``vlog_tpu/codecs/hevc``) on the CPU.

Inputs are seeded numpy frames at 64x96 and 96x128 (2-3 CTB rows). The
JAX functions run as the JAX package's own tests run them (XLA on the
CPU). Tolerance: exact. Every stage here is integer arithmetic, so
levels, reconstructions and boundary strengths must be identical bit for
bit; the port's transforms run their products in float64, exact for
these integer inputs in any summation order.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.fixtures.media import synthetic_yuv_frames
from tests.test_torch_backend import one_torch_thread  # noqa: F401

I32 = torch.int32


def _t(a, dtype=None):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _padded(n: int, w: int, h: int, seed: int = 0):
    """n seeded frames padded to CTB alignment: (y, u, v) uint8 stacks."""
    from vlog_tpu.codecs.hevc.encoder import _pad

    frames = synthetic_yuv_frames(n, w, h, seed=seed)
    return tuple(np.stack([_pad(f[k], 32 >> (k > 0)) for f in frames])
                 for k in range(3))


# ---------------------------------------------------------------- host copies

@pytest.mark.parametrize("name", ["tables", "transform"])
def test_tables_equal_reference(name):
    """The copied normative tables and transform constants are the
    reference's, value for value."""
    import importlib

    ref = importlib.import_module(f"vlog_tpu.codecs.hevc.{name}")
    port = importlib.import_module(f"vlog_tpu_torch.codecs.hevc.{name}")
    names = [k for k, v in vars(ref).items()
             if k.isupper() or k.startswith("_C") or k == "_QPC"]
    assert names
    for k in names:
        a, b = getattr(ref, k), getattr(port, k)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, k
    if name == "transform":
        assert [port.chroma_qp(q) for q in range(52)] == \
            [ref.chroma_qp(q) for q in range(52)]


def test_committed_c_tables_match_generator():
    """native/hevc_tables.inc is the JAX package's generator output."""
    from pathlib import Path

    from vlog_tpu.native.gen_hevc_tables import generate_c_header

    import vlog_tpu_torch.native as nat

    inc = Path(nat.__file__).parent / "hevc_tables.inc"
    assert inc.read_text() == generate_c_header()


@pytest.mark.parametrize("w,h", [(96, 64), (128, 96), (1920, 1080),
                                 (1280, 720), (854, 480), (640, 360)])
def test_syntax_writers_equal_reference(w, h):
    from vlog_tpu.codecs.hevc import syntax as js
    from vlog_tpu_torch.codecs.hevc import syntax as ts

    assert ts.level_idc_for(w, h) == js.level_idc_for(w, h)
    assert ts.coded_dims(w, h) == js.coded_dims(w, h)
    assert ts.write_vps(ts.level_idc_for(w, h)).to_bytes() == \
        js.write_vps(js.level_idc_for(w, h)).to_bytes()
    assert ts.write_sps(w, h).to_bytes() == js.write_sps(w, h).to_bytes()
    for deblock in (False, True):
        assert ts.write_pps(deblock=deblock).to_bytes() == \
            js.write_pps(deblock=deblock).to_bytes()
    payload = bytes(range(7)) * 3
    for qp in (10, 37):
        assert ts.idr_nal(qp, payload).to_bytes() == \
            js.idr_nal(qp, payload).to_bytes()
    assert ts.annexb([ts.write_pps()]) == js.annexb([js.write_pps()])


@pytest.mark.parametrize("qp", [22, 51])
def test_numpy_encoder_equals_reference(qp):
    """``encoder.py`` (the host second reference) emits the reference's
    NAL and reconstruction."""
    from vlog_tpu.codecs.hevc.encoder import encode_frame as jenc
    from vlog_tpu_torch.codecs.hevc.encoder import encode_frame as tenc

    y, u, v = synthetic_yuv_frames(1, 96, 64, seed=3)[0]
    a, b = jenc(y, u, v, qp), tenc(y, u, v, qp)
    assert a.nal.to_bytes() == b.nal.to_bytes()
    for k in ("recon_y", "recon_u", "recon_v"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


# ---------------------------------------------------------------- intra DSP

def test_chroma_qp_traced_equals_table():
    from vlog_tpu.codecs.hevc.transform import chroma_qp
    from vlog_tpu_torch.codecs.hevc.core import chroma_qp_traced

    got = chroma_qp_traced(torch.arange(-3, 56, dtype=I32)).tolist()
    assert got == [chroma_qp(min(max(q, 0), 51)) for q in range(-3, 56)]


@pytest.mark.parametrize("qp", [10, 30, 51])
@pytest.mark.parametrize("deblock", [False, True])
def test_encode_frame_dsp_equals_jax(qp, deblock):
    import jax.numpy as jnp

    from vlog_tpu.codecs.hevc.jax_core import encode_frame_dsp as jfn
    from vlog_tpu_torch.codecs.hevc.core import encode_frame_dsp as tfn

    y, u, v = _padded(1, 128, 96, seed=qp)
    (jl, jr) = jfn(jnp.asarray(y[0]), jnp.asarray(u[0]), jnp.asarray(v[0]),
                   qp, deblock=deblock)
    (tl, tr) = tfn(_t(y), _t(u), _t(v), _t([qp], I32), deblock=deblock)
    for a, b in zip(jl + jr, tl + tr):
        assert b.shape[0] == 1
        np.testing.assert_array_equal(np.asarray(a), b[0].numpy())
    assert tr[0].dtype == torch.uint8 and tl[0].dtype == I32


@pytest.mark.parametrize("qp", [10, 30, 51])
def test_encode_frame_dsp_equals_numpy_encoder(qp):
    """Without deblocking the device recon is the numpy reference's."""
    from vlog_tpu_torch.codecs.hevc.core import encode_frame_dsp
    from vlog_tpu_torch.codecs.hevc.encoder import encode_frame

    y, u, v = synthetic_yuv_frames(1, 96, 64, seed=qp)[0]
    y_, u_, v_ = _padded(1, 96, 64, seed=qp)
    _, rec = encode_frame_dsp(_t(y_), _t(u_), _t(v_), _t([qp], I32))
    ref = encode_frame(y, u, v, qp)
    for a, b in zip((ref.recon_y, ref.recon_u, ref.recon_v), rec):
        np.testing.assert_array_equal(a, b[0].numpy())


def test_encode_frame_dsp_batch_of_qps():
    """Frames of one batch at different QPs: each row equals its own
    reference call (the per-row shifts and table lookups broadcast)."""
    import jax.numpy as jnp

    from vlog_tpu.codecs.hevc.jax_core import encode_frame_dsp as jfn
    from vlog_tpu_torch.codecs.hevc.core import encode_frame_dsp as tfn

    y, u, v = _padded(3, 96, 64, seed=5)
    qps = [12, 33, 47]
    tl, tr = tfn(_t(y), _t(u), _t(v), _t(qps, I32), deblock=True)
    for i, qp in enumerate(qps):
        jl, jr = jfn(jnp.asarray(y[i]), jnp.asarray(u[i]), jnp.asarray(v[i]),
                     qp, deblock=True)
        for a, b in zip(jl + jr, tl + tr):
            np.testing.assert_array_equal(np.asarray(a), b[i].numpy())


# ---------------------------------------------------------------- deblocking

def _blocky(rng, n, h, w, cell):
    base = rng.integers(50, 206, (n, h // cell, w // cell))
    out = np.kron(base, np.ones((1, cell, cell))) + rng.integers(-2, 3, (n, h, w))
    return np.clip(out, 0, 255).astype(np.int32)


@pytest.mark.parametrize("qp", [18, 30, 45, 51])
def test_deblock_picture_intra_equals_jax(qp):
    from vlog_tpu.codecs.hevc import deblock as jd
    from vlog_tpu.codecs.hevc.transform import chroma_qp
    from vlog_tpu_torch.codecs.hevc import deblock as td

    rng = np.random.default_rng(qp)
    h, w = 96, 128
    y = _blocky(rng, 2, h, w, 8)
    u, v = _blocky(rng, 2, h // 2, w // 2, 8), _blocky(rng, 2, h // 2, w // 2, 4)
    qps = [qp, max(qp - 9, 0)]
    jbv, jbh = jd.intra_bs(h // 32, w // 32)
    tbv, tbh = td.intra_bs(h // 32, w // 32, "cpu")
    np.testing.assert_array_equal(np.asarray(jbv), tbv.numpy())
    np.testing.assert_array_equal(np.asarray(jbh), tbh.numpy())
    got = td.deblock_picture(_t(y), _t(u), _t(v), qp=_t(qps, I32),
                             qpc=_t([chroma_qp(q) for q in qps], I32),
                             bs_v=tbv, bs_h=tbh, chroma=True)
    changed = 0
    for i, q in enumerate(qps):
        want = jd.deblock_picture(y[i], u[i], v[i], qp=q, qpc=chroma_qp(q),
                                  bs_v=jbv, bs_h=jbh, chroma=True)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b[i].numpy())
        changed += int((np.asarray(want[0]) != y[i]).sum())
    assert changed > 0        # the filter engaged


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deblock_picture_p_bs_equals_jax(seed):
    """Random partitions, cbf and MVs: the P boundary strengths and the
    luma-only filter."""
    from vlog_tpu.codecs.hevc import deblock as jd
    from vlog_tpu_torch.codecs.hevc import deblock as td

    rng = np.random.default_rng(seed)
    n, rr, cc = 2, 3, 4
    h, w = 32 * rr, 32 * cc
    part = rng.integers(0, 3, (n, rr, cc)).astype(np.int32)
    cbf = rng.random((n, 2 * rr, 2 * cc)) < 0.5
    mv = rng.integers(-6, 7, (n, 2 * rr, 2 * cc, 2)).astype(np.int32)
    y = _blocky(rng, n, h, w, 8)
    u, v = _blocky(rng, n, h // 2, w // 2, 8), _blocky(rng, n, h // 2, w // 2, 8)
    qps = [int(q) for q in rng.integers(25, 52, n)]
    tbv, tbh = td.p_bs(_t(part), _t(cbf), _t(mv))
    got = td.deblock_picture(_t(y), _t(u), _t(v), qp=_t(qps, I32),
                             qpc=_t(qps, I32), bs_v=tbv, bs_h=tbh, chroma=False)
    for i in range(n):
        jbv, jbh = jd.p_bs(part[i], cbf[i], mv[i])
        np.testing.assert_array_equal(np.asarray(jbv), tbv[i].numpy())
        np.testing.assert_array_equal(np.asarray(jbh), tbh[i].numpy())
        want = jd.deblock_picture(y[i], u[i], v[i], qp=qps[i], qpc=qps[i],
                                  bs_v=jbv, bs_h=jbh, chroma=False)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b[i].numpy())
        np.testing.assert_array_equal(got[1][i].numpy(), u[i])   # chroma kept
