"""The HEVC ladder run (``codec="h265"``), port of
``vlog_tpu/backends/hevc_path.py::run_hevc``.

Per dispatch: host read or decode (the prefetch thread) -> the fused
HEVC ladder (parallel/hevc_ladder.py: the resize kernel, the I+P chain
DSP with in-loop deblocking and the in-chain rate cascade, every rung)
on the run's compute stream -> asynchronous device-to-host copy of
int16 levels and MVs -> host CABAC (native, one frame per pool thread)
in one consumer thread per rung -> CMAF segments with hvc1 sample
entries; the stages overlap through the H.264 path's
``PipelineExecutor`` (parallel/executor.py). Under the mesh scheduler
the ladder runs on the lease's (data x rung) grid
(``hevc_ladder.py::hevc_chain_ladder_grid``: rung columns, each
column's chains split over its data devices) and decode on the lease's
first device; the batch math keys off the grid's data width only. The
tree has the H.264 path's shape
(playlists, DASH manifest, thumbnail), so players and resume work
unchanged. CMAF only: MPEG-TS carries H.264.

Batching and the rate-control schedule are the reference's: whole
chains per dispatch, observations of batch k applied before dispatch of
batch k + PIPELINE_DEPTH, and right after each batch while a controller
is hunting. A resumed run restarts at the first segment any rung is
missing, with cold controllers (the HEVC path keeps no journal) and the
original thumbnail. A dispatch encodes only the chains that hold real
frames (padded with copies of the last frame to the data width), and a
lone chain only its real frames; the reference encodes the replicated
tail too and drops it, so the bytes are the same.

Each dispatch leaves a record in ``RunResult.dispatches`` (the
executor's ``timed_dispatch``: enqueue and compute-done host times, the
wall on the device's clock), and the loop's steps are stage spans
(``executor.decode_wait``, ``executor.plan``, ``executor.reserve``,
``executor.dispatch``, ``executor.submit``) for a profiler session on
the dispatch thread.
"""

from __future__ import annotations

import time

import numpy as np

from vlog_tpu_torch import config
from vlog_tpu_torch.backends.base import THUMBNAIL_NAME, RunResult
from vlog_tpu_torch.backends.rate_control import RateController
from vlog_tpu_torch.backends.source import open_source
from vlog_tpu_torch.codecs.hevc.api import HevcEncoder
from vlog_tpu_torch.media.fmp4 import (Sample, TrackConfig, hvc1_sample_entry,
                                       init_segment, media_segment)
from vlog_tpu_torch.obs.trace import STAGE_KEYS, stage
from vlog_tpu_torch.parallel.compile_cache import ensure_compile_cache
from vlog_tpu_torch.parallel.executor import (DecodePrefetch,
                                              LaggedRateControl,
                                              PipelineExecutor,
                                              dispatch_streams)
from vlog_tpu_torch.parallel.hevc_ladder import hevc_chain_ladder_grid
from vlog_tpu_torch.parallel.scheduler import (host_pool_for_run,
                                               placement_for_run)
from vlog_tpu_torch.utils.fsio import atomic_write_bytes, prepare_init_segment

_KEYS = ("i_luma", "i_cb", "i_cr", "p_luma", "p_cb", "p_cr", "mv", "sse_y",
         "qp_eff", "cost")


def run_hevc(backend, plan, progress_cb, resume: bool, t0: float) -> RunResult:
    if plan.streaming_format != "cmaf":
        raise ValueError("h265 output is CMAF-only (hls_ts carries H.264)")
    out = plan.out_dir
    fps = plan.fps_num / plan.fps_den
    frames_per_seg = max(1, round(plan.segment_duration_s * fps))
    timescale = plan.fps_num * 1000
    frame_dur = plan.fps_den * 1000
    clen = max(1, plan.gop_len)
    tag = f"hevc:partitions={int(config.HEVC_PARTITIONS)}:gop={plan.gop_len}"
    rungs_spec = tuple((r.name, r.height, r.width, r.qp) for r in plan.rungs)
    hint = max(1, -(-plan.frame_batch // clen))
    # the lease's first device and grid under the scheduler, else the
    # backend's device (every visible card for a generic "cuda")
    dev, grid = placement_for_run(backend.device, rungs_spec, hint)
    # batch math keys off the grid's data width only
    data = grid.data if grid is not None else 1
    chains_per = max(data, hint + (-hint) % data)
    batch_n = clen * chains_per
    ensure_compile_cache()
    out.mkdir(parents=True, exist_ok=True)

    encoders, tracks = {}, {}
    seg_durs: dict[str, list[float]] = {}
    bytes_written: dict[str, int] = {}
    psnr_acc: dict[str, list[float]] = {}
    pending: dict[str, list[Sample]] = {}
    init_matched: dict[str, bool] = {}
    for rung in plan.rungs:
        enc = HevcEncoder(width=rung.width, height=rung.height,
                          fps_num=plan.fps_num, fps_den=plan.fps_den,
                          qp=rung.qp, deblock=config.HEVC_DEBLOCK, device=dev)
        encoders[rung.name] = enc
        tracks[rung.name] = TrackConfig(
            track_id=1, handler="vide", timescale=timescale,
            sample_entry=hvc1_sample_entry(rung.width, rung.height,
                                           enc.hvcc_config),
            width=rung.width, height=rung.height)
        rdir = out / rung.name
        rdir.mkdir(parents=True, exist_ok=True)
        init_matched[rung.name] = prepare_init_segment(
            rdir, init_segment(tracks[rung.name]), config_tag=tag)
        seg_durs[rung.name] = []
        bytes_written[rung.name] = 0
        psnr_acc[rung.name] = []
        pending[rung.name] = []

    src = open_source(plan.source.path, dev)
    try:
        total = src.frame_count
        start_segment = 0
        if resume and src.exact_seek:
            per_rung = backend._scan_resume_candidates(plan, out, init_matched)
            start_segment = min(len(d) for d in per_rung.values())
            backend._apply_resume_state(plan, per_rung, start_segment,
                                        timescale, seg_durs, bytes_written)
        start_frame = start_segment * frames_per_seg
        thumb_path = None
        if plan.thumbnail and start_segment > 0 \
                and (out / THUMBNAIL_NAME).exists():
            # a resumed run keeps the original first-frame thumbnail
            thumb_path = str(out / THUMBNAIL_NAME)

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
        rungs_by_name = {r.name: r for r in plan.rungs}
        # cumulative busy seconds per stage (obs/trace.py STAGE_KEYS); the
        # executor adds its overlap gauges
        prof = dict.fromkeys(STAGE_KEYS, 0.0)

        def write_segment(rung, chunk: list[Sample]) -> None:
            name = rung.name
            idx = len(seg_durs[name])
            base_time = int(round(sum(seg_durs[name]) * timescale))
            data = media_segment(tracks[name], idx + 1, base_time, chunk)
            atomic_write_bytes(out / name / f"segment_{idx + 1:05d}.m4s", data)
            seg_durs[name].append(sum(s.duration for s in chunk) / timescale)
            bytes_written[name] += len(data)

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
                mse = np.maximum(sse[ci, :keep] / npix[name], 1e-12)
                psnrs = np.where(mse < 1e-9, 99.0,
                                 10 * np.log10(255.0 ** 2 / mse))
                frames = encoders[name].entropy_chain(
                    (host["i_luma"][ci], host["i_cb"][ci], host["i_cr"][ci]),
                    (host["p_luma"][ci], host["p_cb"][ci], host["p_cr"][ci])
                    if keep > 1 else None,
                    None, None, host["mv"][ci] if keep > 1 else None,
                    qarr[ci], rows, cols, psnrs, t_real=keep,
                    pool=pipe.host_pool)
                for f in frames:
                    psnr_acc[name].append(f.psnr_y)
                    pending[name].append(Sample(data=f.sample,
                                                duration=frame_dur,
                                                is_sync=f.is_idr))
                    batch_bytes += len(f.sample)
                n_frames += keep
            rc.post(name, batch.index, nbytes=batch_bytes,
                    frames=max(n_frames, 1),
                    frame_qps=np.concatenate(rc_qs) if rc_qs else None,
                    cost=cost_sum)
            pipe.prof_add("entropy_s", time.perf_counter() - te)
            tw = time.perf_counter()
            while len(pending[name]) >= frames_per_seg:
                chunk = pending[name][:frames_per_seg]
                pending[name] = pending[name][frames_per_seg:]
                write_segment(rungs_by_name[name], chunk)
            pipe.prof_add("package_s", time.perf_counter() - tw)

        frames_done = start_frame

        def on_batch_done(batch) -> None:
            # serialized and in batch order (the executor's contract)
            nonlocal frames_done
            frames_done += batch.n_real
            if progress_cb:
                progress_cb(frames_done, total, "hevc ladder")

        pipe = PipelineExecutor(
            [r.name for r in plan.rungs],
            pull=lambda name, batch: batch.d2h.host(name), process=process,
            ready=lambda batch: batch.d2h.wait_compute(),
            on_batch_done=on_batch_done,
            host_pool=host_pool_for_run(),   # shared across slot jobs
            prof=prof, name="vlog-pipe")
        prefetch = None
        try:
            # the reference's one-batch decode prefetch
            prefetch = DecodePrefetch(src, batch_n, start_frame, maxsize=1)
            batch_idx = 0
            with dispatch_streams(prog.devices):
                while True:
                    td = time.perf_counter()
                    with stage("executor.decode_wait"):
                        item = prefetch.get()
                    prof["decode_wait_s"] += time.perf_counter() - td
                    if item is None:
                        break
                    n_real = item[0].shape[0]
                    if plan.thumbnail and thumb_path is None:
                        # the first batch's first frame, on the host pool
                        thumb_path = str(out / THUMBNAIL_NAME)
                        pipe.submit_aux(backend._write_thumbnail,
                                        *(p[0] for p in item), thumb_path,
                                        1280, dev)
                    # only the chains holding real frames (a lone chain
                    # only up to its last real frame), padded to the
                    # data width
                    real = -(-n_real // clen)
                    lead = (real + (-real) % data,
                            clen if real > 1 else n_real)
                    n_disp = lead[0] * lead[1]
                    # backpressure before planning, then the lagged
                    # feedback: every depth plans the same QPs
                    with stage("executor.reserve"):
                        pipe.reserve()
                    with stage("executor.plan"):
                        rc.apply_upto(batch_idx - pipe.depth)
                        pipe.note_pad_waste(n_real, n_disp)
                        # tail: replicate the last frame, dropped after
                        # encode
                        planes = [(np.concatenate(
                            [p, np.repeat(p[-1:], n_disp - n_real, 0)])
                            if n_disp > n_real else p)
                            .reshape(lead + p.shape[1:]) for p in item]
                        qps = {r.name: np.ascontiguousarray(
                                   controllers[r.name].frame_qps(batch_n)
                                   .reshape(chains_per, clen)
                                   [:lead[0], :lead[1]])
                               for r in plan.rungs}
                        rc_params = {r.name:
                                     controllers[r.name].device_rc_params()
                                     for r in plan.rungs}
                    # each column stages the batch on its devices and
                    # leaves its rungs' outputs there
                    with stage("executor.dispatch"), \
                            pipe.timed_dispatch(n_disp, prog.devices) as rec:
                        outs = prog.dispatch(*planes, qps, rc_params)
                    with stage("executor.submit"):
                        pipe.submit({r.name: {k: outs[r.name][k]
                                              for k in _KEYS}
                                     for r in plan.rungs}, n_real, qps,
                                    record=rec)
                    del outs, planes
                    batch_idx += 1
                    if rc.hunting():
                        # calibration or cliff hunt: drain to depth 0 so
                        # every correction lands before the next batch
                        pipe.drain()
                        rc.apply_upto(batch_idx - 1)
                pipe.drain()
            for rung in plan.rungs:                  # trailing partials
                if pending[rung.name]:
                    write_segment(rung, pending[rung.name])
                    pending[rung.name] = []
        finally:
            if prefetch is not None:
                prefetch.close()
            pipe.close()
    finally:
        src.close()

    # an inexact (libav) source's frame count is an estimate: trust the
    # frames actually decoded
    true_total = total if src.exact_seek else frames_done
    duration_s = true_total / fps if fps else 0.0
    results, variants = backend._publish(plan, encoders, seg_durs,
                                         bytes_written, psnr_acc, duration_s)
    return RunResult(
        rungs=results, frames_processed=frames_done, duration_s=duration_s,
        thumbnail_path=thumb_path, wall_s=time.monotonic() - t0,
        variants=variants, fps=fps,
        segment_duration_s=plan.segment_duration_s,
        stage_s={k: round(v, 3) for k, v in prof.items()} | pipe.gauges(),
        gop_len=plan.gop_len, resumed_segments=start_segment * len(plan.rungs),
        dispatches=pipe.dispatches)
