"""The fused HEVC chain ladder (port of
``vlog_tpu/parallel/hevc_ladder.py``: the one-device body of
``_hevc_chain_ladder_cached`` and its grid).

One call per dispatch emits every hvc1 rung: per rung, resize (the fused
kernel on CUDA), edge-pad to CTB (32) alignment, the I+P chain DSP
(codecs/hevc/core.py) batched over the dispatch's chains with in-loop
deblocking and the device rate-control cascade, the display-region SSE
per frame, and int16 levels and MVs out; reconstructions never leave the
device. Every CTB is a 2Nx2N inter CU (no partitions), the C entropy
coder's contract. Over several devices :func:`hevc_chain_ladder_grid`
lays the ladder out as a (data x rung) grid (``ladder.GridProgram``).
Stage spans (``obs/trace.py::stage``): ``hevc.rung`` per rung, with
``hevc.resize`` (resize and CTB padding) under it and the chain DSP's
own spans (``codecs/hevc/core.py``).
"""

from __future__ import annotations

from typing import Callable

import torch

from vlog_tpu_torch.codecs.h264.inter import edge_pad
from vlog_tpu_torch.codecs.hevc.core import encode_chain_dsp
from vlog_tpu_torch.codecs.hevc.syntax import CTB
from vlog_tpu_torch.device import resolve_device
from vlog_tpu_torch.obs.trace import stage
from vlog_tpu_torch.ops.fused_resize import resize_yuv420
from vlog_tpu_torch.parallel.ladder import (GridProgram, RungSpec,
                                            _as_tensor, _grid_program,
                                            ladder_matrices, mats_from_numpy)

I16 = torch.int16


def _pad_ctb(y, u, v):
    """Edge-pad a (n, H, W) YUV420 batch to CTB (32) alignment."""
    h, w = y.shape[-2], y.shape[-1]
    ph, pw = (-h) % CTB, (-w) % CTB
    if ph or pw:
        y = edge_pad(y, 0, ph, 0, pw)
        u = edge_pad(u, 0, ph // 2, 0, pw // 2)
        v = edge_pad(v, 0, ph // 2, 0, pw // 2)
    return y, u, v


def _sse(rec_y: torch.Tensor, src_y: torch.Tensor, h: int, w: int):
    err = (rec_y[..., :h, :w].to(torch.float32)
           - src_y[..., :h, :w].to(torch.float32))
    return (err * err).sum((-2, -1))


def _one_rung(y, u, v, rung_mats, qps, h, w, *, search, deblock, rcr):
    n, clen = y.shape[0], y.shape[1]
    flat = lambda p: p.reshape((n * clen,) + tuple(p.shape[2:]))  # noqa: E731
    with stage("hevc.resize"):
        py, pu, pv = _pad_ctb(*resize_yuv420(flat(y), flat(u), flat(v),
                                             rung_mats))
    unflat = lambda p: p.reshape((n, clen) + tuple(p.shape[1:]))  # noqa: E731
    py, pu, pv = unflat(py), unflat(pu), unflat(pv)

    # the program applies the I frame's -2 anchor to the plan QP
    qp_i = torch.clamp(qps[:, 0] - 2, min=10)
    qp_p = qps[:, 1:] if clen > 1 else qps
    res = encode_chain_dsp(py, pu, pv, search, qp_i, qp_p, False, deblock, rcr)
    (intra, recon0), (p32, _, _, mvs, precons) = res[0], res[1]
    sse = _sse(recon0[0], py[:, 0], h, w)[:, None]
    if clen > 1:
        sse = torch.cat([sse, _sse(precons[0], py[:, 1:], h, w)], 1)
    else:
        p32 = tuple(torch.zeros((n, 0) + tuple(a.shape[1:]), dtype=a.dtype,
                                device=a.device) for a in intra)
        mvs = torch.zeros((n, 0, 1, 1, 2), dtype=torch.int32, device=y.device)
    out = {"i_luma": intra[0].to(I16), "i_cb": intra[1].to(I16),
           "i_cr": intra[2].to(I16), "p_luma": p32[0].to(I16),
           "p_cb": p32[1].to(I16), "p_cr": p32[2].to(I16),
           "mv": mvs.to(I16), "sse_y": sse}
    if rcr is not None:
        # the host re-derives the I anchor from slot 0: qp_eff[0] carries
        # the plan value
        out["qp_eff"] = torch.cat([qps[:, :1], res[2]["qp_eff"]], 1).to(I16)
        out["cost"] = res[2]["cost"]
    return out


def hevc_chain_ladder_program(rungs: tuple[RungSpec, ...], src_h: int,
                              src_w: int, *, search: int = 16,
                              deblock: bool = True,
                              device="cuda") -> tuple[Callable, dict]:
    """The HEVC I+P chain ladder step for one device.

    Returns ``(fn, mats)``; ``fn(y, u, v, mats, qps, rc=None)`` takes
    y/u/v (n_chains, clen, H, W) uint8 tensors, ``qps`` {rung:
    (n_chains, clen) int32} (slot 0 the chain's plan QP) and optionally
    ``rc`` {rung: {"budget", "alpha"}}. Per rung it returns the JAX
    program's dict: i_luma (n, R, C, 32, 32), i_cb/i_cr (n, R, C, 16,
    16), p_luma/p_cb/p_cr (n, clen-1, ...) and mv (n, clen-1, 2R, 2C, 2)
    int16 (quarter pels, (y, x)), sse_y (n, clen) float32 over the
    display region, and with ``rc`` also qp_eff (n, clen) int16 and cost
    (n, clen) float32. A chain of one frame is intra only.
    """
    dev = resolve_device(device)
    mats = mats_from_numpy(ladder_matrices(rungs, src_h, src_w), dev)

    def fn(y, u, v, mats, qps, rc=None):
        y, u, v = (torch.as_tensor(p, device=dev) for p in (y, u, v))
        out = {}
        for name, h, w, _ in rungs:
            with stage("hevc.rung"):
                out[name] = _one_rung(
                    y, u, v, mats[name],
                    _as_tensor(qps[name], dev, torch.int32), h, w,
                    search=search, deblock=deblock,
                    rcr=None if rc is None else rc[name])
        return out

    return fn, mats


def hevc_chain_ladder_grid(rungs: tuple[RungSpec, ...], src_h: int,
                           src_w: int, *, search: int = 16, grid=None,
                           deblock: bool = True,
                           device="cuda") -> GridProgram:
    """The HEVC chain ladder over ``grid`` (a ``mesh.RungGrid``): per
    column :func:`hevc_chain_ladder_program` on each data device, the
    chain axis split over the data axis; ``grid=None`` is the one-device
    program on ``device``. Same dispatch surface as the H.264 grids."""
    return _grid_program(
        ("hevc", rungs, src_h, src_w, search, deblock),
        lambda col, dev: hevc_chain_ladder_program(
            col, src_h, src_w, search=search, deblock=deblock, device=dev),
        rungs, grid, device, chain=True)
