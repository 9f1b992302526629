"""The PyTorch/CUDA ladder backend: a Y4M source in, a CMAF tree out
(port of the H.264 I+P path of ``vlog_tpu/backends/jax_backend.py``).

Per dispatch batch of whole chains: host Y4M read -> device ladder
program (parallel/ladder.py: resize kernel, intra + P encode, deblock,
in-chain rate adaptation) -> device-to-host copy of int16 levels and MVs
-> host CABAC (native) -> fMP4 segments. Output per rung:

    {out}/{rung}/init.mp4, encoder.tag, segment_%05d.m4s, playlist.m3u8

plus ``master.m3u8`` and ``manifest.mpd`` at the root.

The batches run serially, but the rate-control schedule is the JAX
backend's: observations of batch k apply before dispatch of batch
k + PIPELINE_DEPTH, and every observation applies right after a batch
while a controller is hunting, so both backends plan the same QPs.
Not in this slice: resume and its rate-control journal, MPEG-TS,
thumbnails, intra-only GOPs, non-Y4M sources.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.backends.base import (
    ExecutionPlan,
    RungResult,
    RunResult,
    plan_rung_geometry,
)
from vlog_tpu_torch.backends.rate_control import RateController
from vlog_tpu_torch.codecs.h264.api import H264Encoder
from vlog_tpu_torch.codecs.h264.encoder import FrameLevels
from vlog_tpu_torch.device import resolve_device
from vlog_tpu_torch.media import hls
from vlog_tpu_torch.media.fmp4 import (Sample, TrackConfig, avc1_sample_entry,
                                       init_segment, media_segment)
from vlog_tpu_torch.media.probe import VideoInfo
from vlog_tpu_torch.media.y4m import Y4mReader, fps_to_fraction
from vlog_tpu_torch.parallel.executor import LaggedRateControl
from vlog_tpu_torch.parallel.ladder import ladder_chain_program
from vlog_tpu_torch.utils.fsio import atomic_write_text, prepare_init_segment

_CHAIN_KEYS = ("i_luma_dc", "i_luma_ac", "i_chroma_dc", "i_chroma_ac",
               "p_luma", "p_chroma_dc", "p_chroma_ac", "mv", "sse_y",
               "qp_eff", "cost")


class TorchBackend:
    """Runs the one-pass I+P ladder on one device (default ``"cuda"``)."""

    name = "torch"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    # ------------------------------------------------------------------
    def plan(self, source: VideoInfo, rungs=None, out_dir: Path | str = ".",
             **opts) -> ExecutionPlan:
        if rungs is None:
            rungs = config.ladder_for_source(source.height)
        codec = opts.get("codec", "h264")
        if codec != "h264":
            raise ValueError(f"codec {codec!r} is not ported")
        fmt = opts.get("streaming_format", config.STREAMING_FORMAT)
        if fmt != "cmaf":
            raise ValueError(f"streaming format {fmt!r} is not ported")
        if opts.get("thumbnail", False):
            raise ValueError("thumbnails are not ported")
        if opts.get("gop_mode", config.GOP_MODE) != "p":
            raise ValueError("only gop_mode='p' (I+P chains) is ported")
        planned = tuple(plan_rung_geometry(source.width, source.height, r)
                        for r in rungs)
        fps_num, fps_den = fps_to_fraction(source.fps or 30.0)
        seg_s = opts.get("segment_duration_s", config.SEGMENT_DURATION_S)
        frames_per_seg = max(1, round(seg_s * fps_num / fps_den))
        # the divisor of frames-per-segment closest to GOP_LEN: segments
        # must start on chain boundaries (IDRs)
        cap = min(frames_per_seg, 2 * config.GOP_LEN)
        divisors = [d for d in range(1, cap + 1) if frames_per_seg % d == 0]
        gop_len = min(divisors, key=lambda d: (abs(d - config.GOP_LEN), -d))
        if gop_len < 2:
            raise ValueError(f"{frames_per_seg} frames per segment leave no "
                             "I+P chain of 2 or more frames")
        return ExecutionPlan(
            source=source, rungs=planned, out_dir=Path(out_dir),
            segment_duration_s=seg_s,
            frame_batch=opts.get("frame_batch", config.TPU_FRAME_BATCH),
            fps_num=fps_num, fps_den=fps_den,
            total_frames=source.frame_count,
            gop_len=gop_len, streaming_format=fmt)

    # ------------------------------------------------------------------
    def run(self, plan: ExecutionPlan, progress_cb=None) -> RunResult:
        t0 = time.monotonic()
        dev = self.device
        out = plan.out_dir
        out.mkdir(parents=True, exist_ok=True)
        fps = plan.fps_num / plan.fps_den
        frames_per_seg = max(1, round(plan.segment_duration_s * fps))
        timescale = plan.fps_num * 1000
        frame_dur = plan.fps_den * 1000
        deblock = config.H264_DEBLOCK
        clen = plan.gop_len

        encoders, tracks = {}, {}
        seg_durs: dict[str, list[float]] = {}
        bytes_written: dict[str, int] = {}
        psnr_acc: dict[str, list[float]] = {}
        pending: dict[str, list[Sample]] = {}
        for rung in plan.rungs:
            enc = H264Encoder(width=rung.width, height=rung.height,
                              fps_num=plan.fps_num, fps_den=plan.fps_den,
                              qp=rung.qp, entropy=config.H264_ENTROPY,
                              deblock=deblock)
            encoders[rung.name] = enc
            tracks[rung.name] = TrackConfig(
                track_id=1, handler="vide", timescale=timescale,
                sample_entry=avc1_sample_entry(rung.width, rung.height,
                                               enc.avcc_config),
                width=rung.width, height=rung.height)
            rdir = out / rung.name
            rdir.mkdir(parents=True, exist_ok=True)
            prepare_init_segment(
                rdir, init_segment(tracks[rung.name]),
                config_tag=(f"h264:{config.H264_ENTROPY}"
                            f":deblock={int(enc.deblock)}:gop={clen}"))
            seg_durs[rung.name] = []
            bytes_written[rung.name] = 0
            psnr_acc[rung.name] = []
            pending[rung.name] = []

        src_h, src_w = plan.source.height, plan.source.width
        rungs_spec = tuple((r.name, r.height, r.width, r.qp)
                           for r in plan.rungs)
        fn, mats = ladder_chain_program(
            rungs_spec, src_h, src_w, search=config.MOTION_SEARCH_RADIUS,
            deblock=deblock, device=dev)
        # whole chains per dispatch, enough to cover frame_batch frames
        chains_per = max(1, -(-plan.frame_batch // clen))
        batch_n = clen * chains_per
        controllers = {r.name: RateController(target_bps=r.video_bitrate,
                                              fps=fps, init_qp=r.qp)
                       for r in plan.rungs}
        rc = LaggedRateControl(controllers)
        npix = {r.name: r.height * r.width for r in plan.rungs}
        prof = {"decode_s": 0.0, "device_s": 0.0, "pull_s": 0.0,
                "entropy_s": 0.0, "package_s": 0.0}

        def write_segment(name: str, chunk: list[Sample]) -> None:
            idx = len(seg_durs[name])
            base_time = int(round(sum(seg_durs[name]) * timescale))
            data = media_segment(tracks[name], idx + 1, base_time, chunk)
            path = out / name / f"segment_{idx + 1:05d}.m4s"
            tmp = path.with_suffix(".m4s.tmp")
            tmp.write_bytes(data)
            tmp.rename(path)
            seg_durs[name].append(sum(s.duration for s in chunk) / timescale)
            bytes_written[name] += len(data)

        def consume(name: str, batch_index: int, host: dict, plan_q,
                    n_real: int) -> None:
            """Entropy-code one rung of one dispatch of chains (display
            order is chain-major) and post its rate observation."""
            i32 = lambda a: np.ascontiguousarray(a, np.int32)  # noqa: E731
            te = time.perf_counter()
            sse, qarr, cost = host["sse_y"], host["qp_eff"], host["cost"]
            batch_bytes, n_frames, cost_sum, rc_qs = 0, 0, 0.0, []
            for ci in range(chains_per):
                base = ci * clen
                if base >= n_real:
                    break
                keep = min(clen, n_real - base)
                # attribute to the plan (outer-loop) working point
                rc_qs.append(plan_q[ci, 1:keep])
                cost_sum += float(cost[ci, :keep].sum())
                lv0 = FrameLevels(
                    luma_dc=i32(host["i_luma_dc"][ci]),
                    luma_ac=i32(host["i_luma_ac"][ci]),
                    chroma_dc=i32(host["i_chroma_dc"][ci]),
                    chroma_ac=i32(host["i_chroma_ac"][ci]),
                    qp=int(qarr[ci, 0]))
                p_list = [{"luma": i32(host["p_luma"][ci, fi]),
                           "chroma_dc": i32(host["p_chroma_dc"][ci, fi]),
                           "chroma_ac": i32(host["p_chroma_ac"][ci, fi]),
                           "mv": i32(host["mv"][ci, fi])}
                          for fi in range(keep - 1)]
                mse = np.maximum(sse[ci, :keep] / npix[name], 1e-12)
                psnrs = np.where(mse < 1e-9, 99.0,
                                 10 * np.log10(255 ** 2 / mse))
                for ef in encoders[name].encode_chain(
                        lv0, p_list, qarr[ci, :keep], psnrs):
                    pending[name].append(Sample(data=ef.avcc,
                                                duration=frame_dur,
                                                is_sync=ef.is_idr))
                    psnr_acc[name].append(ef.psnr_y)
                    batch_bytes += len(ef.avcc)
                n_frames += keep
            rc_mix = np.concatenate(rc_qs) if rc_qs else None
            if rc_mix is not None and rc_mix.size == 0:
                rc_mix = None
            rc.post(name, batch_index, nbytes=batch_bytes,
                    frames=max(n_frames, 1), frame_qps=rc_mix, cost=cost_sum)
            prof["entropy_s"] += time.perf_counter() - te
            tw = time.perf_counter()
            while len(pending[name]) >= frames_per_seg:
                chunk = pending[name][:frames_per_seg]
                pending[name] = pending[name][frames_per_seg:]
                write_segment(name, chunk)
            prof["package_s"] += time.perf_counter() - tw

        frames_done = 0
        reader = Y4mReader(plan.source.path)
        try:
            total = reader.info.frame_count
            batch_idx = 0
            for start in range(0, total, batch_n):
                td = time.perf_counter()
                n_real = min(batch_n, total - start)
                frames = [reader.read_frame(i)
                          for i in range(start, start + n_real)]
                # tail: replicate the last frame, dropped after encode
                frames += [frames[-1]] * (batch_n - n_real)
                planes = [torch.from_numpy(np.stack([f[p] for f in frames]))
                          .reshape((chains_per, clen)
                                   + frames[0][p].shape).to(dev)
                          for p in range(3)]
                prof["decode_s"] += time.perf_counter() - td

                rc.apply_upto(batch_idx - config.PIPELINE_DEPTH)
                qps, rc_params = {}, {}
                for r in plan.rungs:
                    # fractional working point -> per-frame dither; the
                    # I frames take the -2 QP anchor
                    q = controllers[r.name].frame_qps(batch_n).reshape(
                        chains_per, clen)
                    q[:, 0] = np.maximum(q[:, 0] - 2, 0)
                    qps[r.name] = q
                    rc_params[r.name] = controllers[r.name].device_rc_params()
                tc = time.perf_counter()
                outs = fn(*planes, mats, qps, rc_params)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                prof["device_s"] += time.perf_counter() - tc
                for r in plan.rungs:
                    tp = time.perf_counter()
                    host = {k: outs[r.name][k].cpu().numpy()
                            for k in _CHAIN_KEYS}
                    prof["pull_s"] += time.perf_counter() - tp
                    consume(r.name, batch_idx, host, qps[r.name], n_real)
                del outs
                batch_idx += 1
                frames_done += n_real
                if progress_cb:
                    progress_cb(frames_done, total,
                                f"encoded {frames_done}/{total} frames")
                if rc.hunting():
                    rc.apply_upto(batch_idx - 1)
            for rung in plan.rungs:                  # trailing partials
                if pending[rung.name]:
                    write_segment(rung.name, pending[rung.name])
                    pending[rung.name] = []
        finally:
            reader.close()

        duration_s = total / fps if fps else 0.0
        results, variants = [], []
        for rung in plan.rungs:
            name = rung.name
            enc = encoders[name]
            playlist = hls.media_playlist(
                [hls.SegmentRef(uri=f"segment_{i + 1:05d}.m4s",
                                duration_s=d)
                 for i, d in enumerate(seg_durs[name])],
                target_duration_s=plan.segment_duration_s,
                init_uri="init.mp4")
            ppath = out / name / "playlist.m3u8"
            atomic_write_text(ppath, playlist)
            total_dur = sum(seg_durs[name])
            achieved = (int(bytes_written[name] * 8 / total_dur)
                        if total_dur else 0)
            results.append(RungResult(
                name=name, width=rung.width, height=rung.height,
                codec_string=enc.codec_string,
                segment_count=len(seg_durs[name]),
                bytes_written=bytes_written[name],
                mean_psnr_y=(float(np.mean(psnr_acc[name]))
                             if psnr_acc[name] else None),
                achieved_bitrate=achieved, playlist_path=str(ppath),
                target_bitrate=rung.video_bitrate))
            variants.append(hls.VariantRef(
                name=name, uri=f"{name}/playlist.m3u8",
                bandwidth=max(achieved, 1), width=rung.width,
                height=rung.height, codecs=enc.codec_string, frame_rate=fps,
                audio_group=(f"aud{rung.audio_bitrate // 1000}"
                             if rung.audio_bitrate else "")))
        atomic_write_text(out / "master.m3u8", hls.master_playlist(variants))
        atomic_write_text(out / "manifest.mpd", hls.dash_manifest(
            variants, duration_s=duration_s,
            segment_duration_s=plan.segment_duration_s))
        return RunResult(
            rungs=results, frames_processed=frames_done,
            duration_s=duration_s, wall_s=time.monotonic() - t0,
            variants=variants, fps=fps,
            segment_duration_s=plan.segment_duration_s,
            stage_s={k: round(v, 3) for k, v in prof.items()},
            gop_len=clen)
