"""The I+P chain ladder program on one device (port of the single-device
body of ``vlog_tpu/parallel/ladder.py::_ladder_chain_cached``).

Per rung and dispatch: resize (the fused kernel on CUDA), MB padding,
the chain's I frame, its P frames as a Python loop over time (each step
batched over the dispatch's chains), in-loop deblocking, and the
device-side in-chain rate adaptation driven by ``cost_proxy``. Levels
leave as int16; reconstructions never leave the device.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from vlog_tpu_torch.codecs.h264.deblock import deblock_frame, intra_bs, p_bs
from vlog_tpu_torch.codecs.h264.encoder import encode_frame
from vlog_tpu_torch.codecs.h264.inter import edge_pad, encode_p_frame
from vlog_tpu_torch.device import resolve_device
from vlog_tpu_torch.ops.bitproxy import cost_proxy
from vlog_tpu_torch.ops.fused_resize import resize_yuv420
from vlog_tpu_torch.ops.resize import plan_ladder_matrices

# Static description of one rung: (name, height, width, qp)
RungSpec = tuple[str, int, int, int]


def _pad_mb(y, u, v):
    """Edge-pad a (n, H, W) YUV420 batch to macroblock alignment (SPS
    cropping restores the display size downstream)."""
    h, w = y.shape[-2], y.shape[-1]
    ph, pw = (-h) % 16, (-w) % 16
    if ph or pw:
        y = edge_pad(y, 0, ph, 0, pw)
        u = edge_pad(u, 0, ph // 2, 0, pw // 2)
        v = edge_pad(v, 0, ph // 2, 0, pw // 2)
    return y, u, v


def ladder_matrices(rungs: tuple[RungSpec, ...], src_h: int,
                    src_w: int) -> dict:
    """{rung name: numpy resize-matrix pytree (None for identity)}."""
    by_hw = plan_ladder_matrices(src_h, src_w,
                                 tuple((h, w) for _, h, w, _ in rungs))
    return {name: by_hw[(h, w)] for name, h, w, _ in rungs}


def mats_from_numpy(mats: dict, device) -> dict:
    """Numpy matrix pytree (either package's ``ladder_matrices``) ->
    float32 tensors on ``device``; None (identity) stays None."""
    dev = torch.device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return {name: None if m is None else
            ((t(m[0][0]), t(m[0][1])), (t(m[1][0]), t(m[1][1])))
            for name, m in mats.items()}


def _sse(rec_y: torch.Tensor, src_y: torch.Tensor, h: int, w: int):
    err = rec_y[:, :h, :w].to(torch.float32) - src_y.to(torch.float32)
    return (err * err).sum((1, 2))


def _as_tensor(x, dev, dtype=None):
    return torch.as_tensor(x, device=dev) if dtype is None else \
        torch.as_tensor(x, device=dev, dtype=dtype)


def _one_rung(y, u, v, rung_mats, qps, h, w, *, search, deblock, rcr):
    n, clen = y.shape[0], y.shape[1]
    if clen < 2:
        raise ValueError("chain programs need chains of >= 2 frames")
    dev = y.device
    flat = lambda p: p.reshape((n * clen,) + tuple(p.shape[2:]))  # noqa: E731
    ry, ru, rv = resize_yuv420(flat(y), flat(u), flat(v), rung_mats)
    py, pu, pv = _pad_mb(ry, ru, rv)
    unflat = lambda p: p.reshape((n, clen) + tuple(p.shape[1:]))  # noqa: E731
    py, pu, pv, ry = unflat(py), unflat(pu), unflat(pv), unflat(ry)
    mbh, mbw = py.shape[-2] // 16, py.shape[-1] // 16

    i_out = encode_frame(py[:, 0], pu[:, 0], pv[:, 0], qp=qps[:, 0])
    rec = (i_out["recon_y"], i_out["recon_u"], i_out["recon_v"])
    if deblock:
        ibs_v, ibs_h = intra_bs(mbh, mbw, dev)
        rec = deblock_frame(*rec, qp=qps[:, 0], bs_v=ibs_v, bs_h=ibs_h)
        rec = tuple(p.to(torch.uint8) for p in rec)
    sses = [_sse(rec[0], ry[:, 0], h, w)]
    if rcr is not None:
        budget = torch.clamp(_as_tensor(rcr["budget"], dev, torch.float32),
                             min=1.0)
        alpha = _as_tensor(rcr["alpha"], dev, torch.float32)
        costs = [cost_proxy(i_out["luma_dc"], i_out["luma_ac"],
                            i_out["chroma_dc"], i_out["chroma_ac"],
                            batch_ndim=1)]
        # balance starts at zero: the I frame's planned overspend is the
        # host outer loop's to account for (see the JAX reference)
        bal = torch.zeros_like(costs[0])
        q_eff = [qps[:, 0].to(torch.int16)]

    p_out = {"luma": [], "chroma_dc": [], "chroma_ac": [], "mv": []}
    for t in range(1, clen):
        if rcr is None:
            q = qps[:, t]
        else:
            adj = torch.clamp(torch.trunc(bal / (3.0 * budget)),
                              -1.0, 8.0).to(torch.int32)
            q = torch.clamp(qps[:, t] + adj, 10, 51)
        pout = encode_p_frame(py[:, t], pu[:, t], pv[:, t], *rec, qp=q,
                              search=search)
        rec = (pout["recon_y"], pout["recon_u"], pout["recon_v"])
        if deblock:
            # bS from what the decoder sees: coded levels + motion field
            nz = (pout["luma"] != 0).any(-1).any(-1)      # (n,mbh,mbw,4,4)
            nz4 = nz.permute(0, 1, 3, 2, 4).reshape(n, 4 * mbh, 4 * mbw)
            bsv, bsh = p_bs(nz4, pout["mv"])
            rec = deblock_frame(*rec, qp=q, bs_v=bsv, bs_h=bsh)
            rec = tuple(p.to(torch.uint8) for p in rec)
        sses.append(_sse(rec[0], ry[:, t], h, w))
        for k in p_out:
            p_out[k].append(pout[k].to(torch.int16))
        if rcr is not None:
            cost = cost_proxy(pout["luma"], pout["chroma_dc"],
                              pout["chroma_ac"], batch_ndim=1)
            # anti-windup: credit floors at 3 frames of budget, debt tops
            # at what +8 QP can repay
            step = torch.where(alpha > 0, cost * alpha - budget,
                               torch.zeros_like(cost))
            bal = torch.minimum(torch.maximum(bal + step, -3.0 * budget),
                                30.0 * budget)
            costs.append(cost)
            q_eff.append(q.to(torch.int16))

    out = {
        "i_luma_dc": i_out["luma_dc"].to(torch.int16),
        "i_luma_ac": i_out["luma_ac"].to(torch.int16),
        "i_chroma_dc": i_out["chroma_dc"].to(torch.int16),
        "i_chroma_ac": i_out["chroma_ac"].to(torch.int16),
        "p_luma": torch.stack(p_out["luma"], 1),
        "p_chroma_dc": torch.stack(p_out["chroma_dc"], 1),
        "p_chroma_ac": torch.stack(p_out["chroma_ac"], 1),
        "mv": torch.stack(p_out["mv"], 1),
        "sse_y": torch.stack(sses, 1),
    }
    if rcr is not None:
        out["qp_eff"] = torch.stack(q_eff, 1)
        out["cost"] = torch.stack(costs, 1)
    return out


def ladder_chain_program(rungs: tuple[RungSpec, ...], src_h: int, src_w: int,
                         *, search: int = 8, deblock: bool = False,
                         device="cuda") -> tuple[Callable, dict]:
    """The I+P chain ladder step for one device.

    Returns ``(fn, mats)``; ``fn(y, u, v, mats, qps, rc=None)`` takes
    y/u/v (n_chains, clen, H, W) uint8 tensors on the device, ``qps``
    {rung: (n_chains, clen) int32} and optionally ``rc`` {rung:
    {"budget", "alpha"}} (the in-chain rate adaptation). Per rung it
    returns the JAX program's dict: i_luma_dc/ac, i_chroma_dc/ac
    (n, ...), p_luma/p_chroma_dc/p_chroma_ac/mv (n, clen-1, ...) int16,
    sse_y (n, clen) float32, and with ``rc`` also qp_eff (n, clen) int16
    and cost (n, clen) float32.
    """
    dev = resolve_device(device)
    mats = mats_from_numpy(ladder_matrices(rungs, src_h, src_w), dev)

    def fn(y, u, v, mats, qps, rc=None):
        y, u, v = (torch.as_tensor(p, device=dev) for p in (y, u, v))
        return {name: _one_rung(
                    y, u, v, mats[name],
                    _as_tensor(qps[name], dev, torch.int32),
                    h, w, search=search, deblock=deblock,
                    rcr=None if rc is None else rc[name])
                for name, h, w, _ in rungs}

    return fn, mats
