"""The HEVC ladder run (``codec="h265"``), port of
``vlog_tpu/backends/hevc_path.py::run_hevc``.

Per dispatch: host read or decode -> the fused HEVC ladder
(parallel/hevc_ladder.py: the resize kernel, the I+P chain DSP with
in-loop deblocking and the in-chain rate cascade, every rung; on the
lease's (data x rung) grid under the mesh scheduler) -> device-to-host
copy of int16 levels and MVs -> host CABAC (native, one frame per pool
thread) in one consumer thread per rung -> CMAF segments with hvc1
sample entries. The batch loop, the rung outputs, resume and publish
are backends/ladder_run.py's, so the tree has the H.264 path's shape
and players and resume work unchanged. CMAF only: MPEG-TS carries
H.264.

HEVC's part: the encoders and ``hvc1`` tracks, the chain program (it
applies the I frame's -2 QP anchor itself), each rung's entropy coding,
and the reference's one-batch decode prefetch. A resumed run restarts
with cold controllers (the HEVC path keeps no journal). A dispatch
encodes only the chains that hold real frames (padded with copies of
the last frame to the data width), and a lone chain only its real
frames; the reference encodes the replicated tail too and drops it, so
the bytes are the same.
"""

from __future__ import annotations

import time

import numpy as np

from vlog_tpu_torch import config
from vlog_tpu_torch.backends.base import RunResult
from vlog_tpu_torch.backends.ladder_run import (LadderRun, RungOutputs,
                                                dispatch_geometry, psnr_y)
from vlog_tpu_torch.backends.rate_control import RateController
from vlog_tpu_torch.backends.source import open_source
from vlog_tpu_torch.codecs.hevc.api import HevcEncoder
from vlog_tpu_torch.media.fmp4 import (TrackConfig, hvc1_sample_entry,
                                       init_segment, media_segment)
from vlog_tpu_torch.parallel.compile_cache import ensure_compile_cache
from vlog_tpu_torch.parallel.executor import LaggedRateControl
from vlog_tpu_torch.parallel.hevc_ladder import hevc_chain_ladder_grid

_KEYS = ("i_luma", "i_cb", "i_cr", "p_luma", "p_cb", "p_cr", "mv", "sse_y",
         "qp_eff", "cost")


def run_hevc(backend, plan, progress_cb, resume: bool, t0: float) -> RunResult:
    if plan.streaming_format != "cmaf":
        raise ValueError("h265 output is CMAF-only (hls_ts carries H.264)")
    fps = plan.fps_num / plan.fps_den
    clen = max(1, plan.gop_len)
    tag = f"hevc:partitions={int(config.HEVC_PARTITIONS)}:gop={plan.gop_len}"
    rungs_spec = tuple((r.name, r.height, r.width, r.qp) for r in plan.rungs)
    dev, grid, data, chains_per, batch_n = dispatch_geometry(
        backend.device, plan, rungs_spec, clen)
    ensure_compile_cache()

    encoders, tracks = {}, {}
    outputs = RungOutputs(plan, lambda rung, index, base_time, chunk:
                          media_segment(tracks[rung.name], index, base_time,
                                        chunk))
    for rung in plan.rungs:
        enc = encoders[rung.name] = HevcEncoder(
            width=rung.width, height=rung.height, fps_num=plan.fps_num,
            fps_den=plan.fps_den, qp=rung.qp, deblock=config.HEVC_DEBLOCK,
            device=dev)
        tracks[rung.name] = TrackConfig(
            track_id=1, handler="vide", timescale=outputs.timescale,
            sample_entry=hvc1_sample_entry(rung.width, rung.height,
                                           enc.hvcc_config),
            width=rung.width, height=rung.height)
        outputs.open(rung, init_segment(tracks[rung.name]), config_tag=tag)

    src = open_source(plan.source.path, dev)
    try:
        total = src.frame_count
        outputs.resume(outputs.resumable() if resume and src.exact_seek
                       else 0)
        prog = hevc_chain_ladder_grid(
            rungs_spec, plan.source.height, plan.source.width,
            search=config.MOTION_SEARCH_RADIUS, grid=grid,
            deblock=config.HEVC_DEBLOCK, device=dev)
        controllers = {r.name: RateController(target_bps=r.video_bitrate,
                                              fps=fps, init_qp=r.qp)
                       for r in plan.rungs}
        rc = LaggedRateControl(controllers)
        npix = {r.name: r.height * r.width for r in plan.rungs}
        rows_cols = {r.name: (-(-r.height // 32), -(-r.width // 32))
                     for r in plan.rungs}

        def process(name: str, batch, host: dict) -> None:
            """Entropy-code one rung of a dispatch, post its rate
            observation, write the segments that are whole."""
            rows, cols = rows_cols[name]
            n_real, plan_q = batch.n_real, batch.qps[name]
            te = time.perf_counter()
            sse, qarr, cost = host["sse_y"], host["qp_eff"], host["cost"]
            batch_bytes, n_frames, cost_sum, rc_qs = 0, 0, 0.0, []
            for ci in range(host["i_luma"].shape[0]):
                keep = min(clen, n_real - ci * clen)
                if keep <= 0:           # a chain padding the data width
                    break
                # attribute to the plan (outer-loop) working point; the
                # program applies the I frame's -2 anchor itself
                rc_qs.append(plan_q[ci, :keep])
                cost_sum += float(cost[ci, :keep].sum())
                frames = encoders[name].entropy_chain(
                    (host["i_luma"][ci], host["i_cb"][ci], host["i_cr"][ci]),
                    (host["p_luma"][ci], host["p_cb"][ci], host["p_cr"][ci])
                    if keep > 1 else None,
                    None, None, host["mv"][ci] if keep > 1 else None,
                    qarr[ci], rows, cols, psnr_y(sse[ci, :keep], npix[name]),
                    t_real=keep, pool=ladder.pipe.host_pool)
                for f in frames:
                    outputs.queue(name, f.sample, f.is_idr, f.psnr_y)
                    batch_bytes += len(f.sample)
                n_frames += keep
            rc.post(name, batch.index, nbytes=batch_bytes,
                    frames=max(n_frames, 1),
                    frame_qps=np.concatenate(rc_qs) if rc_qs else None,
                    cost=cost_sum)
            ladder.pipe.prof_add("entropy_s", time.perf_counter() - te)
            outputs.write_whole(name, ladder.pipe.prof_add)

        def lead(n_real: int) -> tuple[int, int]:
            # only the chains holding real frames (a lone chain only up to
            # its last real frame), padded to the data width
            real = -(-n_real // clen)
            return real + (-real) % data, clen if real > 1 else n_real

        def plan_args(lead: tuple[int, int]) -> tuple[dict, dict]:
            return ({r.name: np.ascontiguousarray(
                        controllers[r.name].frame_qps(batch_n)
                        .reshape(chains_per, clen)[:lead[0], :lead[1]])
                     for r in plan.rungs},
                    {r.name: controllers[r.name].device_rc_params()
                     for r in plan.rungs})

        with LadderRun(plan, outputs, src, process, progress_cb=progress_cb,
                       report=lambda n: (total, "hevc ladder")) as ladder:
            # the reference's one-batch decode prefetch
            ladder.dispatch(prog, rc, batch_n=batch_n, prefetch=1, keys=_KEYS,
                            lead=lead, plan_args=plan_args,
                            write_thumbnail=backend._write_thumbnail,
                            device=dev)
    finally:
        src.close()
    return ladder.result({r.name: encoders[r.name].codec_string
                          for r in plan.rungs}, t0=t0, gop_len=plan.gop_len)
