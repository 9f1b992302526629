"""The ladder programs (port of ``vlog_tpu/parallel/ladder.py``): the
one-device bodies of ``_ladder_chain_cached`` and
``_ladder_encode_cached``, and their (data x rung) grids.

``ladder_encode_program`` is the intra-only step (``gop_mode="intra"``):
resize, MB padding and one batched intra encode per rung.
``ladder_chain_program`` is the I+P chain step. Per rung and dispatch:
resize (the fused kernel on CUDA), MB padding,
the chain's I frame, its P frames as a Python loop over time (each step
batched over the dispatch's chains), in-loop deblocking, and the
device-side in-chain rate adaptation driven by ``cost_proxy``. Levels
leave as int16; reconstructions never leave the device.

Over several devices a ladder lays out as a (data x rung) grid
(:class:`GridProgram`, :func:`ladder_chain_grid`,
:func:`ladder_encode_grid`): one program per rung column, each column's
batch split into one shard per data device. :func:`sharded_ladder_step`
is the dry run's step, whose PSNR sums the per-shard partials in data
order where the reference reduces with ``psum``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
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
from vlog_tpu_torch.parallel.executor import dispatch_stream
from vlog_tpu_torch.parallel.mesh import Sharded, data_devices, shard_frames

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


def ladder_encode_program(rungs: tuple[RungSpec, ...], src_h: int,
                          src_w: int, *, device="cuda") -> tuple[Callable, dict]:
    """The intra-only ladder step for one device (port of the
    single-device body of ``_ladder_encode_cached`` + ``_encode_rung``).

    Returns ``(fn, mats)``; ``fn(y, u, v, mats, qps)`` takes y/u/v (n, H,
    W) uint8 tensors and ``qps`` {rung: (n,) int32}; per rung: resize
    (the fused kernel on CUDA), MB padding, one batched intra encode at
    the per-frame QPs. It returns int16 ``luma_dc/luma_ac/chroma_dc/
    chroma_ac`` (n, ...) and float32 ``sse_y`` (n,) over the display
    region; reconstructions stay on the device.
    """
    dev = resolve_device(device)
    mats = mats_from_numpy(ladder_matrices(rungs, src_h, src_w), dev)

    def fn(y, u, v, mats, qps):
        y, u, v = (torch.as_tensor(p, device=dev) for p in (y, u, v))
        out = {}
        for name, h, w, _ in rungs:
            ry, ru, rv = resize_yuv420(y, u, v, mats[name])
            levels = encode_frame(*_pad_mb(ry, ru, rv),
                                  qp=_as_tensor(qps[name], dev, torch.int32))
            out[name] = {k: levels[k].to(torch.int16) for k in
                         ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac")}
            out[name]["sse_y"] = _sse(levels["recon_y"], ry, h, w)
        return out

    return fn, mats


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


def _encode_rung(y, u, v, rung_mats, qp):
    """Resize, MB-pad and intra-encode one rung at ``qp`` (a scalar or an
    (n,) vector); returns (``encode_frame`` output, resized luma)."""
    ry, ru, rv = resize_yuv420(y, u, v, rung_mats)
    q = torch.broadcast_to(_as_tensor(qp, y.device, torch.int32),
                           (y.shape[0],)).contiguous()
    return encode_frame(*_pad_mb(ry, ru, rv), qp=q), ry


def ladder_local(y, u, v, mats: dict, rungs: tuple[RungSpec, ...],
                 qps=None) -> dict:
    """Device-local body: frames (n, H, W) -> every rung's
    ``encode_frame`` output (levels and reconstructions) at the rung's
    static QP, or at ``qps[name]`` (per-frame) when given."""
    return {name: _encode_rung(y, u, v, mats[name],
                               qp if qps is None else qps[name])[0]
            for name, _, _, qp in rungs}


# --- the (data x rung) grid -------------------------------------------------

class GridProgram:
    """One-call dispatch of a ladder over a (data x rung) grid (the
    reference's ``GridProgram``, MPMD over its per-column submeshes).

    ``columns`` holds, per rung column, ``(names, devices, progs)``: the
    column's rung names, its data devices in data order, and one
    ``(fn, mats)`` per data device (the column's rungs' matrices staged
    on that device; a device repeated in the list shares one).
    :meth:`dispatch` splits the batch along its leading (frame or chain)
    axis into one shard per data device and runs the column's program
    on each shard on the shard's device, inside that device's compute
    stream; every column gets the whole batch (the rung-axis
    replication) and only its own rungs' QP and RC. A rung's outputs are
    tensors on its device when its column is one device wide, else
    :class:`Sharded` (a shard per data device, in data order; the host
    copy concatenates them). ``data`` is the data-axis width (the batch
    must divide by it), ``label`` the shape ("1x1" on one device)."""

    def __init__(self, columns: tuple, data: int, label: str, chain: bool):
        self.columns = columns
        self.data = data
        self.label = label
        self._chain = chain

    @property
    def devices(self) -> tuple:
        """The distinct devices the program dispatches on, in order."""
        return tuple(dict.fromkeys(d for _, devs, _ in self.columns
                                   for d in devs))

    def dispatch(self, y, u, v, qps: dict, rc: dict | None = None) -> dict:
        """Stage and run every column; returns {rung name: outputs}."""
        k = y.shape[0] // self.data
        outs = {}
        for names, devices, progs in self.columns:
            sy, su, sv = shard_frames(devices, y, u, v)
            shards = []
            for i, (dev, (fn, mats)) in enumerate(zip(devices, progs)):
                planes = (sy[i], su[i], sv[i])
                with dispatch_stream(dev):
                    cq = {name: qps[name][i * k:(i + 1) * k]
                          for name in names}
                    if self._chain:
                        crc = None if rc is None else \
                            {name: rc[name] for name in names}
                        shards.append(fn(*planes, mats, cq, crc))
                    else:
                        shards.append(fn(*planes, mats, cq))
            if len(shards) == 1:
                outs.update(shards[0])
                continue
            for name in names:
                outs[name] = {key: Sharded(s[name][key] for s in shards)
                              for key in shards[0][name]}
        return outs


# (kind, geometry, options, grid layout) -> GridProgram, most recent last
_GRIDS: OrderedDict = OrderedDict()     # under _GRIDS_LOCK
_GRIDS_LOCK = threading.Lock()
_GRIDS_MAX = 8


def grid_layout(grid) -> tuple:
    """A grid's value key: its label and, per column, the rungs and the
    data devices (a port ``Mesh`` hashes by identity)."""
    return (grid.label, tuple((col.rungs, tuple(data_devices(col.mesh)))
                              for col in grid.columns))


def _grid_program(key: tuple, build: Callable, rungs: tuple, grid,
                  device, chain: bool) -> GridProgram:
    """``build(col_rungs, device) -> (fn, mats)`` laid out over ``grid``.
    ``grid=None`` is one column on ``device``, built anew (the
    one-device path); a grid's program is cached on its layout, so a
    second run on the same grid reuses the staged matrices."""
    if grid is None:
        dev = resolve_device(device)
        names = tuple(r[0] for r in rungs)
        return GridProgram(((names, (dev,), (build(rungs, dev),)),), 1,
                           "1x1", chain)
    key = key + (grid_layout(grid),)
    with _GRIDS_LOCK:
        prog = _GRIDS.get(key)
        if prog is not None:
            _GRIDS.move_to_end(key)
            return prog
        cols = []
        for col in grid.columns:
            devices = tuple(resolve_device(d)
                            for d in data_devices(col.mesh))
            per_dev: dict = {}
            for d in devices:
                if d not in per_dev:
                    per_dev[d] = build(col.rungs, d)
            cols.append((col.names, devices,
                         tuple(per_dev[d] for d in devices)))
        prog = GridProgram(tuple(cols), grid.data, grid.label, chain)
        _GRIDS[key] = prog
        while len(_GRIDS) > _GRIDS_MAX:
            _GRIDS.popitem(last=False)
    return prog


def ladder_encode_grid(rungs: tuple[RungSpec, ...], src_h: int, src_w: int,
                       grid=None, *, device="cuda") -> GridProgram:
    """The intra ladder over ``grid`` (a ``mesh.RungGrid``): per column
    :func:`ladder_encode_program` on each data device; ``grid=None`` is
    the one-device program on ``device``."""
    return _grid_program(
        ("intra", rungs, src_h, src_w),
        lambda col, dev: ladder_encode_program(col, src_h, src_w,
                                               device=dev),
        rungs, grid, device, chain=False)


def ladder_chain_grid(rungs: tuple[RungSpec, ...], src_h: int, src_w: int,
                      *, search: int = 8, grid=None, deblock: bool = False,
                      device="cuda") -> GridProgram:
    """The I+P chain ladder over ``grid``: per column
    :func:`ladder_chain_program` on each data device, the chain axis
    split over the data axis (chains are independent mini-GOPs);
    ``grid=None`` is the one-device program on ``device``."""
    return _grid_program(
        ("chain", rungs, src_h, src_w, search, deblock),
        lambda col, dev: ladder_chain_program(col, src_h, src_w,
                                              search=search,
                                              deblock=deblock, device=dev),
        rungs, grid, device, chain=True)


def _mesh_mats(mesh, rungs, src_h: int, src_w: int) -> tuple[tuple, dict]:
    """The data devices of ``mesh`` and the rungs' matrices staged once
    on each distinct one ({device: mats})."""
    devices = tuple(resolve_device(d) for d in data_devices(mesh))
    host = ladder_matrices(rungs, src_h, src_w)
    return devices, {d: mats_from_numpy(host, d) for d in dict.fromkeys(devices)}


def sharded_ladder_levels(mesh, rungs: tuple[RungSpec, ...], src_h: int,
                          src_w: int) -> tuple[Callable, dict]:
    """The intra ladder step sharded over ``mesh``'s data axis.

    Returns ``(fn, mats)``; ``fn(y, u, v, mats)`` splits the frames (the
    count must divide by the data width) into one shard per data device
    and returns per rung the ``encode_frame`` dict with every array
    :class:`Sharded`; ``mats`` maps each distinct device to its staged
    matrices."""
    devices, mats = _mesh_mats(mesh, rungs, src_h, src_w)

    def fn(y, u, v, mats):
        shards = []
        for d, *planes in zip(devices, *shard_frames(devices, y, u, v)):
            with dispatch_stream(d):
                shards.append(ladder_local(*planes, mats[d], rungs))
        return {name: {k: Sharded(s[name][k] for s in shards)
                       for k in shards[0][name]} for name, *_ in rungs}

    return fn, mats


def sharded_ladder_step(mesh, rungs: tuple[RungSpec, ...], src_h: int,
                        src_w: int) -> tuple[Callable, dict]:
    """Ladder step plus per-rung mean PSNR-Y (the dry run's step).

    ``fn(y, u, v, mats, valid) -> (levels, stats)``: ``valid`` is an (n,)
    float32 0/1 mask (:func:`valid_mask`) split like the frames, so
    pad_batch's duplicated frames never bias the statistics. Each shard
    computes its sum of valid frames' MSE over the display region in
    float32; the sums of the shards (and their valid counts) add up in
    data order on the host, where the reference reduces with ``psum``.
    ``stats[name]`` is a float32 tensor."""
    devices, mats = _mesh_mats(mesh, rungs, src_h, src_w)

    def fn(y, u, v, mats, valid):
        shards, partials = [], []
        for d, sy, su, sv, sm in zip(devices, *shard_frames(
                devices, y, u, v, valid)):
            with dispatch_stream(d):
                out, part = {}, {}
                vm = sm.to(torch.float32)
                for name, h, w, qp in rungs:
                    out[name], ry = _encode_rung(sy, su, sv, mats[d][name],
                                                 qp)
                    err = (out[name]["recon_y"][:, :h, :w].to(torch.float32)
                           - ry.to(torch.float32))
                    # pulled inside the device's compute stream, which
                    # orders the copy after the kernels queued there
                    part[name] = ((vm * (err * err).mean((1, 2))).sum().cpu(),
                                  vm.sum().cpu())
            shards.append(out)
            partials.append(part)
        stats = {}
        for name, *_ in rungs:
            total_mse = torch.zeros((), dtype=torch.float32)
            total_n = torch.zeros((), dtype=torch.float32)
            for part in partials:
                total_mse = total_mse + part[name][0]
                total_n = total_n + part[name][1]
            mse = total_mse / torch.clamp(total_n, min=1.0)
            stats[name] = 10.0 * torch.log10(
                255.0 ** 2 / torch.clamp(mse, min=1e-6))
        levels = {name: {k: Sharded(s[name][k] for s in shards)
                         for k in shards[0][name]} for name, *_ in rungs}
        return levels, stats

    return fn, mats


def valid_mask(n_total: int, n_real: int) -> torch.Tensor:
    """0/1 float32 mask marking pad_batch's duplicated trailing frames
    invalid."""
    return (torch.arange(n_total) < n_real).to(torch.float32)
