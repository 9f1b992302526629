"""The HEVC ladder run (``codec="h265"``), port of
``vlog_tpu/backends/hevc_path.py::run_hevc``.

Per dispatch: host read or decode -> the fused HEVC ladder
(parallel/hevc_ladder.py: the resize kernel, the I+P chain DSP with
in-loop deblocking and the in-chain rate cascade, every rung) ->
device-to-host copy of int16 levels and MVs -> host CABAC (native, one
frame per thread) -> CMAF segments with hvc1 sample entries. The tree
has the H.264 path's shape (playlists, DASH manifest, thumbnail), so
players and resume work unchanged. CMAF only: MPEG-TS carries H.264.

Batching and the rate-control schedule are the reference's: whole
chains per dispatch, observations of batch k applied before dispatch of
batch k + PIPELINE_DEPTH, and right after each batch while a controller
is hunting. A resumed run restarts at the first segment any rung is
missing, with cold controllers (the HEVC path keeps no journal) and the
original thumbnail. A dispatch encodes only the chains that hold real
frames, and a lone chain only its real frames; the reference encodes
the replicated tail too and drops it, so the bytes are the same.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.backends.base import THUMBNAIL_NAME, RunResult
from vlog_tpu_torch.backends.rate_control import RateController
from vlog_tpu_torch.backends.source import open_source
from vlog_tpu_torch.codecs.hevc.api import HevcEncoder
from vlog_tpu_torch.media.fmp4 import (Sample, TrackConfig, hvc1_sample_entry,
                                       init_segment, media_segment)
from vlog_tpu_torch.parallel.executor import LaggedRateControl
from vlog_tpu_torch.parallel.hevc_ladder import hevc_chain_ladder_program
from vlog_tpu_torch.utils.fsio import atomic_write_bytes, prepare_init_segment

_KEYS = ("i_luma", "i_cb", "i_cr", "p_luma", "p_cb", "p_cr", "mv", "sse_y",
         "qp_eff", "cost")


def run_hevc(backend, plan, progress_cb, resume: bool, t0: float) -> RunResult:
    if plan.streaming_format != "cmaf":
        raise ValueError("h265 output is CMAF-only (hls_ts carries H.264)")
    dev = backend.device
    out = plan.out_dir
    out.mkdir(parents=True, exist_ok=True)
    fps = plan.fps_num / plan.fps_den
    frames_per_seg = max(1, round(plan.segment_duration_s * fps))
    timescale = plan.fps_num * 1000
    frame_dur = plan.fps_den * 1000
    clen = max(1, plan.gop_len)
    tag = f"hevc:partitions={int(config.HEVC_PARTITIONS)}:gop={plan.gop_len}"

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
    pool = ThreadPoolExecutor(config.ENTROPY_THREADS,
                              thread_name_prefix="vlog-entropy")
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

        rungs_spec = tuple((r.name, r.height, r.width, r.qp)
                           for r in plan.rungs)
        fn, mats = hevc_chain_ladder_program(
            rungs_spec, plan.source.height, plan.source.width,
            search=config.MOTION_SEARCH_RADIUS, deblock=config.HEVC_DEBLOCK,
            device=dev)
        chains_per = max(1, -(-plan.frame_batch // clen))
        batch_n = clen * chains_per
        controllers = {r.name: RateController(target_bps=r.video_bitrate,
                                              fps=fps, init_qp=r.qp)
                       for r in plan.rungs}
        rc = LaggedRateControl(controllers)
        depth = config.PIPELINE_DEPTH
        npix = {r.name: r.height * r.width for r in plan.rungs}
        rows_cols = {r.name: (-(-r.height // 32), -(-r.width // 32))
                     for r in plan.rungs}
        prof = {"decode_s": 0.0, "device_s": 0.0, "pull_s": 0.0,
                "entropy_s": 0.0, "package_s": 0.0, "thumbnail_s": 0.0}

        def write_segment(rung, chunk: list[Sample]) -> None:
            name = rung.name
            idx = len(seg_durs[name])
            base_time = int(round(sum(seg_durs[name]) * timescale))
            data = media_segment(tracks[name], idx + 1, base_time, chunk)
            atomic_write_bytes(out / name / f"segment_{idx + 1:05d}.m4s", data)
            seg_durs[name].append(sum(s.duration for s in chunk) / timescale)
            bytes_written[name] += len(data)

        def consume(rung, batch_index: int, host: dict, plan_q,
                    n_real: int) -> None:
            """Entropy-code one rung of a dispatch, post its rate
            observation, write the segments that are whole."""
            name = rung.name
            rows, cols = rows_cols[name]
            te = time.perf_counter()
            sse, qarr, cost = host["sse_y"], host["qp_eff"], host["cost"]
            batch_bytes, n_frames, cost_sum, rc_qs = 0, 0, 0.0, []
            for ci in range(host["i_luma"].shape[0]):
                keep = min(clen, n_real - ci * clen)
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
                    qarr[ci], rows, cols, psnrs, t_real=keep, pool=pool)
                for f in frames:
                    psnr_acc[name].append(f.psnr_y)
                    pending[name].append(Sample(data=f.sample,
                                                duration=frame_dur,
                                                is_sync=f.is_idr))
                    batch_bytes += len(f.sample)
                n_frames += keep
            rc.post(name, batch_index, nbytes=batch_bytes,
                    frames=max(n_frames, 1),
                    frame_qps=np.concatenate(rc_qs) if rc_qs else None,
                    cost=cost_sum)
            prof["entropy_s"] += time.perf_counter() - te
            tw = time.perf_counter()
            while len(pending[name]) >= frames_per_seg:
                chunk = pending[name][:frames_per_seg]
                pending[name] = pending[name][frames_per_seg:]
                write_segment(rung, chunk)
            prof["package_s"] += time.perf_counter() - tw

        frames_done = start_frame
        batch_idx = 0
        batches = src.read_batches(batch_n, start_frame)
        while True:
            td = time.perf_counter()
            item = next(batches, None)
            prof["decode_s"] += time.perf_counter() - td
            if item is None:
                break
            n_real = item[0].shape[0]
            if plan.thumbnail and thumb_path is None:
                thumb_path = str(out / THUMBNAIL_NAME)
                tt = time.perf_counter()
                backend._write_thumbnail(*(p[0] for p in item), thumb_path)
                prof["thumbnail_s"] += time.perf_counter() - tt
            td = time.perf_counter()
            # only the chains holding real frames; a lone chain only up to
            # its last real frame
            n_chains = -(-n_real // clen)
            lead = (n_chains, clen if n_chains > 1 else n_real)
            n_disp = lead[0] * lead[1]
            # tail: replicate the last frame, dropped after encode
            planes = [torch.from_numpy(np.concatenate(
                          [p, np.repeat(p[-1:], n_disp - n_real, 0)])
                          if n_disp > n_real else p)
                      .reshape(lead + p.shape[1:]).to(dev)
                      for p in item]
            prof["decode_s"] += time.perf_counter() - td

            rc.apply_upto(batch_idx - depth)
            qps = {r.name: np.ascontiguousarray(
                       controllers[r.name].frame_qps(batch_n)
                       .reshape(chains_per, clen)[:lead[0], :lead[1]])
                   for r in plan.rungs}
            tc = time.perf_counter()
            outs = fn(*planes, mats, qps,
                      {r.name: controllers[r.name].device_rc_params()
                       for r in plan.rungs})
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            prof["device_s"] += time.perf_counter() - tc
            for r in plan.rungs:
                tp = time.perf_counter()
                host = {k: outs[r.name][k].cpu().numpy() for k in _KEYS}
                prof["pull_s"] += time.perf_counter() - tp
                consume(r, batch_idx, host, qps[r.name], n_real)
            del outs
            batch_idx += 1
            frames_done += n_real
            if progress_cb:
                progress_cb(frames_done, total, "hevc ladder")
            if rc.hunting():
                rc.apply_upto(batch_idx - 1)
        for rung in plan.rungs:                  # trailing partials
            if pending[rung.name]:
                write_segment(rung, pending[rung.name])
                pending[rung.name] = []
    finally:
        pool.shutdown()
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
        stage_s={k: round(v, 3) for k, v in prof.items()},
        gop_len=plan.gop_len, resumed_segments=start_segment * len(plan.rungs))
