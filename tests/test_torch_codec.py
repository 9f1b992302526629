"""Integer codec stages of the port against the JAX package, from
identical uint8 inputs: intra encode, P-frame encode (ME/MC/residual),
deblocking with intra and P boundary strengths, and the CABAC slice
writers. Tolerance: bit-exact everywhere.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlog_tpu.codecs.h264 import cabac_enc as jcabac
from vlog_tpu.codecs.h264 import deblock as jdb
from vlog_tpu.codecs.h264 import encoder as jenc
from vlog_tpu.codecs.h264 import inter as jinter
from vlog_tpu_torch.codecs.h264 import cabac_enc as tcabac
from vlog_tpu_torch.codecs.h264 import deblock as tdb
from vlog_tpu_torch.codecs.h264 import encoder as tenc
from vlog_tpu_torch.codecs.h264 import inter as tinter

H, W = 48, 80           # 3 x 5 macroblocks
QPS = (12, 24, 33, 44)  # one per frame


def _frames(n: int, seed: int = 0):
    """Smooth moving content with noise: real motion for ME, block
    edges for the deblocking filter."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    out = []
    for t in range(n):
        y = (120 + 60 * np.sin((xx + 3 * t) / 9.0) * np.cos((yy + 2 * t) / 7.0)
             + rng.normal(0, 3, (H, W)))
        y[10 + t:26 + t, 20 + 2 * t:36 + 2 * t] += 50
        u = 128 + 40 * np.sin((xx[::2, ::2] + 2 * t) / 6.0)
        v = 128 + 40 * np.cos((yy[::2, ::2] + t) / 5.0)
        out.append(tuple(np.clip(p, 0, 255).astype(np.uint8) for p in (y, u, v)))
    return [np.stack(p) for p in zip(*out)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_dict_equal(got: dict, want: dict, idx: int):
    assert set(got) == set(want)
    for k in want:
        a, b = got[k][idx].numpy(), np.asarray(want[k])
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_intra_encode_bit_exact_per_frame_qp():
    y, u, v = _frames(len(QPS))
    got = tenc.encode_frame(_t(y), _t(u), _t(v),
                            qp=torch.tensor(QPS, dtype=torch.int32))
    for i, qp in enumerate(QPS):
        _assert_dict_equal(got, jenc.encode_frame(y[i], u[i], v[i], qp=qp), i)
    assert tenc.chroma_qp(40) == jenc.chroma_qp(40)


@pytest.mark.parametrize("search", [2, 4])
def test_p_frame_encode_bit_exact(search):
    y, u, v = _frames(len(QPS) + 1, seed=search)
    refs = [jenc.encode_frame(y[i], u[i], v[i], qp=QPS[i])
            for i in range(len(QPS))]
    ref = [np.stack([np.asarray(r[k]) for r in refs])
           for k in ("recon_y", "recon_u", "recon_v")]
    got = tinter.encode_p_frame(_t(y[1:]), _t(u[1:]), _t(v[1:]),
                                *map(_t, ref), search=search,
                                qp=torch.tensor(QPS, dtype=torch.int32))
    moved = 0
    for i, qp in enumerate(QPS):
        want = jinter.encode_p_frame(y[i + 1], u[i + 1], v[i + 1],
                                     ref[0][i], ref[1][i], ref[2][i],
                                     qp=qp, search=search)
        _assert_dict_equal(got, want, i)
        moved += int(np.any(np.asarray(want["mv"]) % 4 != 0))
    assert moved, "no sub-pel motion exercised"


def _p_bs_inputs(luma: np.ndarray, mv: np.ndarray):
    nz = np.any(luma != 0, axis=(-1, -2))
    mbh, mbw = luma.shape[0], luma.shape[1]
    return np.transpose(nz, (0, 2, 1, 3)).reshape(4 * mbh, 4 * mbw), mv


@pytest.mark.parametrize("kind", ["intra", "p"])
def test_deblock_bit_exact(kind):
    y, u, v = _frames(len(QPS) + 1, seed=11)
    mbh, mbw = H // 16, W // 16
    planes, bs, want = [], [], []
    for i, qp in enumerate(QPS):
        i_out = jenc.encode_frame(y[i], u[i], v[i], qp=qp)
        rec = [np.asarray(i_out[k]) for k in ("recon_y", "recon_u", "recon_v")]
        if kind == "intra":
            bv, bh = jdb.intra_bs(mbh, mbw)
        else:
            p = jinter.encode_p_frame(y[i + 1], u[i + 1], v[i + 1], *rec,
                                      qp=qp, search=3)
            rec = [np.asarray(p[k]) for k in ("recon_y", "recon_u", "recon_v")]
            bv, bh = jdb.p_bs(*map(jnp.asarray, _p_bs_inputs(
                np.asarray(p["luma"]), np.asarray(p["mv"]))))
        planes.append(rec)
        bs.append((np.asarray(bv), np.asarray(bh)))
        want.append([np.asarray(a) for a in
                     jdb.deblock_frame(*rec, qp=qp, bs_v=bv, bs_h=bh)])
    stack = lambda j: _t(np.stack([p[j] for p in planes]))   # noqa: E731
    bsv = _t(np.stack([b[0] for b in bs]))
    bsh = _t(np.stack([b[1] for b in bs]))
    got = tdb.deblock_frame(stack(0), stack(1), stack(2),
                            qp=torch.tensor(QPS, dtype=torch.int32),
                            bs_v=bsv, bs_h=bsh)
    changed = 0
    for i in range(len(QPS)):
        for j in range(3):
            np.testing.assert_array_equal(got[j][i].numpy(), want[i][j])
            changed += int((want[i][j] != planes[i][j]).sum())
    assert changed > 0, "the filter never fired"


def test_boundary_strengths_bit_exact():
    y, u, v = _frames(3, seed=5)
    i_out = jenc.encode_frame(y[0], u[0], v[0], qp=30)
    rec = [np.asarray(i_out[k]) for k in ("recon_y", "recon_u", "recon_v")]
    luma, mvs = [], []
    for f in (1, 2):
        p = jinter.encode_p_frame(y[f], u[f], v[f], *rec, qp=30, search=3)
        luma.append(np.asarray(p["luma"]))
        mvs.append(np.asarray(p["mv"]))
    nz4 = np.stack([_p_bs_inputs(lv, mv)[0] for lv, mv in zip(luma, mvs)])
    got_v, got_h = tdb.p_bs(_t(nz4), _t(np.stack(mvs)))
    for i in range(2):
        want_v, want_h = jdb.p_bs(jnp.asarray(nz4[i]), jnp.asarray(mvs[i]))
        np.testing.assert_array_equal(got_v[i].numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_h[i].numpy(), np.asarray(want_h))
    iv, ih = tdb.intra_bs(3, 5, "cpu")
    np.testing.assert_array_equal(iv.numpy(), np.asarray(jdb.intra_bs(3, 5)[0]))
    np.testing.assert_array_equal(ih.numpy(), np.asarray(jdb.intra_bs(3, 5)[1]))


@pytest.mark.parametrize("deblock", [False, True])
def test_cabac_slices_byte_identical(deblock):
    y, u, v = _frames(2, seed=2)
    i_out = jenc.encode_frame(y[0], u[0], v[0], qp=26)
    lv = {k: np.asarray(i_out[k]) for k in
          ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")}
    j_lv = jenc.FrameLevels(qp=26, **lv)
    t_lv = tenc.FrameLevels(qp=26, **lv)
    kw = dict(qp=27, init_qp=30, frame_num=0, idr=True, idr_pic_id=1,
              deblock=deblock)
    assert (tcabac.encode_slice_cabac(t_lv, **kw).to_bytes()
            == jcabac.encode_slice_cabac(j_lv, **kw).to_bytes())
    rec = [np.asarray(i_out[k]) for k in ("recon_y", "recon_u", "recon_v")]
    p = jinter.encode_p_frame(y[1], u[1], v[1], *rec, qp=28, search=3)
    pl = {k: np.asarray(p[k], np.int32) for k in
          ("luma", "chroma_dc", "chroma_ac", "mv")}
    kw = dict(qp=28, init_qp=30, frame_num=1, deblock=deblock)
    assert (tcabac.encode_p_slice_cabac(pl, **kw).to_bytes()
            == jcabac.encode_p_slice_cabac(pl, **kw).to_bytes())
