"""The PyTorch/CUDA ladder backend: a source in, an HLS tree out (port of
the H.264 path of ``vlog_tpu/backends/jax_backend.py``).

Sources open through ``backends/source.py::open_source``: Y4M, an MP4 in
the first-party H.264 envelope (decoded on the backend's device), or a
foreign file through the libav shim. Per dispatch batch: host read or
decode -> device ladder program
(parallel/ladder.py: the resize kernel, then I+P chains with deblocking
and in-chain rate adaptation, or intra-only frames) -> device-to-host
copy of int16 levels (and MVs) -> host CABAC or CAVLC (native) ->
segments. Output per rung, CMAF (default):

    {out}/{rung}/init.mp4, encoder.tag, segment_%05d.m4s, playlist.m3u8

plus ``master.m3u8``, ``manifest.mpd``, ``rc_journal.jsonl`` and
``thumbnail.jpg`` at the root. ``streaming_format="hls_ts"`` writes
``segment_%05d.ts`` (ADTS audio muxed in when the plan carries it) and
no init segment, DASH manifest or journal.

The batches run serially, but the rate-control schedule is the JAX
backend's: observations of batch k apply before dispatch of batch
k + PIPELINE_DEPTH, and every observation applies right after a batch
while a controller is hunting, so both backends plan the same QPs and
write the same journal. A CMAF run resumes from the segments on disk
(``run(..., resume=True)``, the default): the resume point is clamped to
a batch boundary the journal can replay, so the resumed tree equals the
uninterrupted one, whichever of the two backends wrote its first part;
a libav source (no frame-exact seek) never resumes. A dispatch whose
real frames fill fewer chains than the batch holds (the source's tail)
encodes only the chains that hold real frames, and a lone partial chain
only up to its last real frame: the JAX program encodes the replicated
padding too and drops it, so the written bytes are the same.
``codec="h265"`` (or ``"hevc"``) runs the HEVC ladder instead
(backends/hevc_path.py, CMAF only); AV1 is not ported.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path

import numpy as np
import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.backends import rc_journal as rcj
from vlog_tpu_torch.backends.base import (
    Capabilities,
    ExecutionPlan,
    RungResult,
    RunResult,
    THUMBNAIL_NAME,
    plan_rung_geometry,
    register_backend,
)
from vlog_tpu_torch.backends.hevc_path import run_hevc
from vlog_tpu_torch.backends.rate_control import RateController
from vlog_tpu_torch.backends.source import open_source
from vlog_tpu_torch.codecs.h264.api import H264Encoder
from vlog_tpu_torch.codecs.h264.encoder import FrameLevels
from vlog_tpu_torch.codecs.jpeg.encoder import (JpegBlocks, pack_jpeg,
                                                quantize_rgb)
from vlog_tpu_torch.device import resolve_device
from vlog_tpu_torch.media import hls
from vlog_tpu_torch.media.boxes import parse_box_tree
from vlog_tpu_torch.media.fmp4 import (Sample, TrackConfig, avc1_sample_entry,
                                       init_segment, media_segment)
from vlog_tpu_torch.media.probe import VideoInfo
from vlog_tpu_torch.media.ts import TsMuxer, TsSample
from vlog_tpu_torch.media.y4m import fps_to_fraction
from vlog_tpu_torch.ops.colorspace import yuv420_to_rgb
from vlog_tpu_torch.ops.fused_resize import resize_yuv420
from vlog_tpu_torch.parallel.executor import LaggedRateControl
from vlog_tpu_torch.parallel.ladder import (ladder_chain_program,
                                            ladder_encode_program,
                                            ladder_matrices, mats_from_numpy)
from vlog_tpu_torch.utils import failpoints
from vlog_tpu_torch.utils.fsio import (atomic_write_bytes, atomic_write_text,
                                       prepare_init_segment)

_CHAIN_KEYS = ("i_luma_dc", "i_luma_ac", "i_chroma_dc", "i_chroma_ac",
               "p_luma", "p_chroma_dc", "p_chroma_ac", "mv", "sse_y",
               "qp_eff", "cost")
_INTRA_KEYS = ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac", "sse_y")


class TorchBackend:
    """Runs the one-pass H.264 or HEVC ladder on one device (default
    ``"cuda"``)."""

    name = "torch"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._thumb_mats = {}       # (h, w, th, tw) -> the thumbnail's matrices

    def detect(self) -> Capabilities:
        """What this backend's device offers; raises on a CUDA device when
        CUDA is missing."""
        dev = resolve_device(self.device)
        if dev.type == "cuda":
            props = torch.cuda.get_device_properties(dev)
            kind, count, mem = "gpu", torch.cuda.device_count(), props.total_memory
            names = [props.name]
        else:
            kind, count, mem, names = "cpu", 1, None, ["cpu"]
        return Capabilities(
            backend=self.name, device_kind=kind, device_count=count,
            codecs=("h264",), decode_codecs=("h264", "raw"),
            max_parallel_jobs=1, memory_bytes=mem,
            details={"devices": names})

    # ------------------------------------------------------------------
    def plan(self, source: VideoInfo, rungs=None, out_dir: Path | str = ".",
             **opts) -> ExecutionPlan:
        if rungs is None:
            rungs = config.ladder_for_source(source.height)
        codec = opts.get("codec", "h264")
        if codec == "hevc":
            codec = "h265"
        if codec == "av1":
            raise ValueError("codec 'av1' is not ported (H.264 and HEVC only)")
        if codec not in ("h264", "h265"):
            raise ValueError(f"unknown codec {codec!r}")
        fmt = opts.get("streaming_format", config.STREAMING_FORMAT)
        if fmt not in ("cmaf", "hls_ts"):
            raise ValueError(f"unknown streaming format {fmt!r}")
        gop_mode = opts.get("gop_mode", config.GOP_MODE)
        if gop_mode not in ("p", "intra"):
            raise ValueError(f"unknown gop_mode {gop_mode!r}")
        planned = tuple(plan_rung_geometry(source.width, source.height, r,
                                           codec=codec) for r in rungs)
        fps_num, fps_den = fps_to_fraction(source.fps or 30.0)
        seg_s = opts.get("segment_duration_s", config.SEGMENT_DURATION_S)
        frames_per_seg = max(1, round(seg_s * fps_num / fps_den))
        gop_len = 1
        if gop_mode == "p":
            # the divisor of frames-per-segment closest to GOP_LEN:
            # segments must start on chain boundaries (IDRs)
            cap = min(frames_per_seg, 2 * config.GOP_LEN)
            divisors = [d for d in range(1, cap + 1) if frames_per_seg % d == 0]
            gop_len = min(divisors, key=lambda d: (abs(d - config.GOP_LEN), -d))
            if gop_len <= max(2, config.GOP_LEN // 3):
                logging.getLogger("vlog_tpu_torch.backend").warning(
                    "gop_mode=p degraded to %d-frame chains "
                    "(frames/segment=%d has no divisor near GOP_LEN=%d)",
                    gop_len, frames_per_seg, config.GOP_LEN)
        return ExecutionPlan(
            source=source, rungs=planned, out_dir=Path(out_dir),
            segment_duration_s=seg_s,
            frame_batch=opts.get("frame_batch", config.TPU_FRAME_BATCH),
            fps_num=fps_num, fps_den=fps_den,
            total_frames=source.frame_count,
            thumbnail=opts.get("thumbnail", True),
            gop_len=gop_len, streaming_format=fmt)

    # ------------------------------------------------------------------
    def run(self, plan: ExecutionPlan, progress_cb=None, *,
            resume: bool = True) -> RunResult:
        failpoints.hit("backend.encode")    # chaos: simulated device fault
        t0 = time.monotonic()
        if any(r.codec == "h265" for r in plan.rungs):
            return run_hevc(self, plan, progress_cb, resume, t0)
        dev = self.device
        out = plan.out_dir
        out.mkdir(parents=True, exist_ok=True)
        fps = plan.fps_num / plan.fps_den
        frames_per_seg = max(1, round(plan.segment_duration_s * fps))
        timescale = plan.fps_num * 1000
        frame_dur = plan.fps_den * 1000
        ts_mode = plan.streaming_format == "hls_ts"
        seg_ext = "ts" if ts_mode else "m4s"
        clen = plan.gop_len
        chain_mode = clen > 1
        # chains run the in-loop deblocking filter; intra frames do not
        deblock = config.H264_DEBLOCK and chain_mode
        tag = f"h264:{config.H264_ENTROPY}:deblock={int(deblock)}"

        encoders, tracks = {}, {}
        seg_durs: dict[str, list[float]] = {}
        bytes_written: dict[str, int] = {}
        psnr_acc: dict[str, list[float]] = {}
        pending: dict[str, list[Sample]] = {}
        init_matched: dict[str, bool] = {}
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
            if not ts_mode:
                init_matched[rung.name] = prepare_init_segment(
                    rdir, init_segment(tracks[rung.name]),
                    config_tag=f"{tag}:gop={clen}")
            seg_durs[rung.name] = []
            bytes_written[rung.name] = 0
            psnr_acc[rung.name] = []
            pending[rung.name] = []

        src = open_source(plan.source.path, dev)
        journal = None
        try:
            total = src.frame_count
            # resume candidate: the first segment any rung is missing (TS
            # restarts from 0, its continuity counters span the whole
            # playlist; a libav source seeks only to keyframes)
            start_segment = 0
            per_rung = None
            if resume and not ts_mode and src.exact_seek:
                per_rung = self._scan_resume_candidates(plan, out, init_matched)
                start_segment = min(len(d) for d in per_rung.values())

            src_h, src_w = plan.source.height, plan.source.width
            rungs_spec = tuple((r.name, r.height, r.width, r.qp)
                               for r in plan.rungs)
            if chain_mode:
                fn, mats = ladder_chain_program(
                    rungs_spec, src_h, src_w,
                    search=config.MOTION_SEARCH_RADIUS, deblock=deblock,
                    device=dev)
                # whole chains per dispatch, enough for frame_batch frames
                chains_per = max(1, -(-plan.frame_batch // clen))
                batch_n = clen * chains_per
            else:
                fn, mats = ladder_encode_program(rungs_spec, src_h, src_w,
                                                 device=dev)
                batch_n = max(plan.frame_batch, 1)
            controllers = {r.name: RateController(target_bps=r.video_bitrate,
                                                  fps=fps, init_qp=r.qp)
                           for r in plan.rungs}
            rc = LaggedRateControl(controllers)
            depth = config.PIPELINE_DEPTH

            # definitive resume point: clamped to a segment boundary that
            # is also a batch boundary with a complete journal prefix,
            # whose replay puts the controllers where the original run had
            # them; otherwise the legacy cold resume
            start_batch = 0
            if not ts_mode:
                jpath = out / rcj.RC_JOURNAL_NAME
                header = rcj.make_header(
                    batch_n=batch_n, depth=depth,
                    frames_per_seg=frames_per_seg, gop_len=clen,
                    rungs=[r.name for r in plan.rungs], tag=tag)
                if start_segment > 0:
                    loaded = rcj.load_journal(jpath)
                    entries = (loaded[1] if loaded is not None
                               and loaded[0] == header else {})
                    a_seg, a_batch = rcj.aligned_resume_point(
                        start_segment, frames_per_seg=frames_per_seg,
                        batch_n=batch_n, entries=entries,
                        rungs=header["rungs"])
                    if a_batch > 0:
                        start_segment, start_batch = a_seg, a_batch
                        rc.replay(entries, start_batch, header["depth"])
                    else:
                        # completed segments still skip re-encoding, but
                        # the controllers start cold: the journal records
                        # the frame this timeline starts from
                        header = {**header, "origin_frame":
                                  start_segment * frames_per_seg}
                    self._apply_resume_state(plan, per_rung, start_segment,
                                             timescale, seg_durs,
                                             bytes_written)
                journal = rcj.RCJournal(jpath, header,
                                        keep_batches=start_batch)
            start_frame = start_segment * frames_per_seg
            for enc in encoders.values():
                enc.start_at(start_frame, clen)
            thumb_path = None
            if plan.thumbnail and start_segment > 0 \
                    and (out / THUMBNAIL_NAME).exists():
                # a resumed run keeps the original first-frame thumbnail
                thumb_path = str(out / THUMBNAIL_NAME)

            npix = {r.name: r.height * r.width for r in plan.rungs}
            prof = {"decode_s": 0.0, "device_s": 0.0, "pull_s": 0.0,
                    "entropy_s": 0.0, "package_s": 0.0, "thumbnail_s": 0.0}

            # MPEG-TS: one muxer per rung for the whole playlist, exact
            # 90 kHz timestamps (multiply before dividing, per index)
            audio_by_rate = plan.audio_adts or {}
            ts_muxers: dict[str, TsMuxer] = {}
            ts_frame_idx = {r.name: start_frame for r in plan.rungs}
            ts_audio_idx = {r.name: 0 for r in plan.rungs}

            def vpts(idx: int) -> int:
                return idx * 90000 * plan.fps_den // plan.fps_num

            def apts(idx: int, sr: int) -> int:
                return idx * 90000 * 1024 // sr

            def segment_bytes(rung, chunk: list[Sample]) -> bytes:
                name = rung.name
                if not ts_mode:
                    base_time = int(round(sum(seg_durs[name]) * timescale))
                    return media_segment(tracks[name], len(seg_durs[name]) + 1,
                                         base_time, chunk)
                audio = audio_by_rate.get(rung.audio_bitrate)
                mux = ts_muxers.get(name)
                if mux is None:
                    mux = ts_muxers[name] = TsMuxer(
                        has_video=True, has_audio=audio is not None)
                i0 = ts_frame_idx[name]
                vsamples = [TsSample(s.data, pts=vpts(i0 + k), is_idr=s.is_sync)
                            for k, s in enumerate(chunk)]
                ts_frame_idx[name] = i0 + len(chunk)
                asamples = []
                if audio is not None:
                    adts, sr = audio
                    t_end = vpts(ts_frame_idx[name])
                    j = ts_audio_idx[name]
                    while j < len(adts) and apts(j, sr) < t_end:
                        asamples.append(TsSample(adts[j], pts=apts(j, sr)))
                        j += 1
                    ts_audio_idx[name] = j
                return mux.mux_segment(video=vsamples, audio=asamples or None)

            def write_segment(rung, chunk: list[Sample]) -> None:
                name = rung.name
                data = segment_bytes(rung, chunk)
                idx = len(seg_durs[name])
                atomic_write_bytes(out / name / f"segment_{idx + 1:05d}.{seg_ext}",
                                   data)
                seg_durs[name].append(sum(s.duration for s in chunk) / timescale)
                bytes_written[name] += len(data)

            def finish(rung, batch_index: int, frames, batch_bytes: int,
                       n_frames: int, rc_mix, cost) -> None:
                """Queue a rung's coded frames, post its rate observation
                (and journal it), write the segments that are whole."""
                name = rung.name
                for ef in frames:
                    pending[name].append(Sample(
                        data=ef.annexb if ts_mode else ef.avcc,
                        duration=frame_dur, is_sync=ef.is_idr))
                    psnr_acc[name].append(ef.psnr_y)
                rc.post(name, batch_index, nbytes=batch_bytes,
                        frames=n_frames, frame_qps=rc_mix, cost=cost)
                if journal is not None:
                    journal.record(batch_index, name, nbytes=batch_bytes,
                                   frames=n_frames, qps=rc_mix, cost=cost)
                tw = time.perf_counter()
                while len(pending[name]) >= frames_per_seg:
                    chunk = pending[name][:frames_per_seg]
                    pending[name] = pending[name][frames_per_seg:]
                    write_segment(rung, chunk)
                prof["package_s"] += time.perf_counter() - tw

            def psnr_of(sse, name):
                mse = np.maximum(sse / npix[name], 1e-12)
                return np.where(mse < 1e-9, 99.0, 10 * np.log10(255 ** 2 / mse))

            def consume_chain(rung, batch_index: int, host: dict, plan_q,
                              n_real: int) -> None:
                """Entropy-code one rung of a dispatch of chains (display
                order is chain-major)."""
                name = rung.name
                i32 = lambda a: np.ascontiguousarray(a, np.int32)  # noqa: E731
                te = time.perf_counter()
                sse, qarr, cost = host["sse_y"], host["qp_eff"], host["cost"]
                frames, n_frames, cost_sum, rc_qs = [], 0, 0.0, []
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
                    frames += encoders[name].encode_chain(
                        lv0, p_list, qarr[ci, :keep],
                        psnr_of(sse[ci, :keep], name))
                    n_frames += keep
                rc_mix = np.concatenate(rc_qs) if rc_qs else None
                if rc_mix is not None and rc_mix.size == 0:
                    rc_mix = None
                prof["entropy_s"] += time.perf_counter() - te
                finish(rung, batch_index, frames,
                       sum(len(ef.avcc) for ef in frames), max(n_frames, 1),
                       rc_mix, cost_sum)

            def consume_intra(rung, batch_index: int, host: dict, plan_q,
                              n_real: int) -> None:
                """Entropy-code one rung of a dispatch of intra frames."""
                name = rung.name
                te = time.perf_counter()
                levels = {k: np.ascontiguousarray(host[k][:n_real], np.int32)
                          for k in _INTRA_KEYS[:4]}
                q_used = plan_q[:n_real]
                frames = encoders[name].encode_levels(
                    levels, q_used, psnr_of(host["sse_y"][:n_real], name))
                prof["entropy_s"] += time.perf_counter() - te
                finish(rung, batch_index, frames,
                       sum(len(ef.avcc) for ef in frames), n_real, q_used,
                       None)

            keys, consume = ((_CHAIN_KEYS, consume_chain) if chain_mode
                             else (_INTRA_KEYS, consume_intra))
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
                    # the first batch's first frame
                    thumb_path = str(out / THUMBNAIL_NAME)
                    tt = time.perf_counter()
                    self._write_thumbnail(*(p[0] for p in item), thumb_path)
                    prof["thumbnail_s"] += time.perf_counter() - tt
                td = time.perf_counter()
                if chain_mode:
                    # only the chains holding real frames; a lone chain
                    # only up to its last real frame (at least 2)
                    n_chains = -(-n_real // clen)
                    lead = (n_chains, clen if n_chains > 1
                            else max(2, n_real))
                else:
                    lead = (batch_n,)
                n_disp = int(np.prod(lead))
                # tail: replicate the last frame, dropped after encode
                planes = [torch.from_numpy(np.concatenate(
                              [p, np.repeat(p[-1:], n_disp - n_real, 0)])
                              if n_disp > n_real else p)
                          .reshape(lead + p.shape[1:]).to(dev)
                          for p in item]
                prof["decode_s"] += time.perf_counter() - td

                rc.apply_upto(batch_idx - depth)
                qps = {}
                for r in plan.rungs:
                    q = controllers[r.name].frame_qps(batch_n)
                    if chain_mode:
                        # the I frames take the -2 QP anchor
                        q = q.reshape(chains_per, clen)
                        q[:, 0] = np.maximum(q[:, 0] - 2, 0)
                        q = np.ascontiguousarray(q[:lead[0], :lead[1]])
                    qps[r.name] = q
                tc = time.perf_counter()
                if chain_mode:
                    outs = fn(*planes, mats, qps,
                              {r.name: controllers[r.name].device_rc_params()
                               for r in plan.rungs})
                else:
                    outs = fn(*planes, mats, qps)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                prof["device_s"] += time.perf_counter() - tc
                for r in plan.rungs:
                    tp = time.perf_counter()
                    host = {k: outs[r.name][k].cpu().numpy() for k in keys}
                    prof["pull_s"] += time.perf_counter() - tp
                    consume(r, batch_idx, host, qps[r.name], n_real)
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
                    write_segment(rung, pending[rung.name])
                    pending[rung.name] = []
        finally:
            src.close()
            if journal is not None:
                journal.close()

        # an inexact (libav) source's frame count is an estimate: trust
        # the frames actually decoded
        true_total = total if src.exact_seek else frames_done
        duration_s = true_total / fps if fps else 0.0
        results, variants = self._publish(plan, encoders, seg_durs,
                                          bytes_written, psnr_acc,
                                          duration_s, audio_by_rate)
        return RunResult(
            rungs=results, frames_processed=frames_done,
            duration_s=duration_s, thumbnail_path=thumb_path,
            wall_s=time.monotonic() - t0, variants=variants, fps=fps,
            segment_duration_s=plan.segment_duration_s,
            stage_s={k: round(v, 3) for k, v in prof.items()},
            gop_len=clen, resumed_segments=start_segment * len(plan.rungs))

    @staticmethod
    def _publish(plan, encoders, seg_durs, bytes_written, psnr_acc,
                 duration_s: float, audio_by_rate=None):
        """Write each rung's media playlist, ``master.m3u8`` and (CMAF)
        ``manifest.mpd``; returns the rung results and the variants."""
        out = plan.out_dir
        fps = plan.fps_num / plan.fps_den
        ts_mode = plan.streaming_format == "hls_ts"
        audio_by_rate = audio_by_rate or {}
        results, variants = [], []
        for rung in plan.rungs:
            name = rung.name
            enc = encoders[name]
            playlist = hls.media_playlist(
                [hls.SegmentRef(uri=f"segment_{i + 1:05d}."
                                    f"{'ts' if ts_mode else 'm4s'}",
                                duration_s=d)
                 for i, d in enumerate(seg_durs[name])],
                target_duration_s=plan.segment_duration_s,
                init_uri=None if ts_mode else "init.mp4")
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
            # TS variants carry muxed AAC: CODECS lists every format and
            # BANDWIDTH includes the audio (RFC 8216)
            muxed = ts_mode and rung.audio_bitrate in audio_by_rate
            variants.append(hls.VariantRef(
                name=name, uri=f"{name}/playlist.m3u8",
                bandwidth=max(achieved, 1)
                + (rung.audio_bitrate if muxed else 0),
                width=rung.width, height=rung.height,
                codecs=(enc.codec_string + ",mp4a.40.2" if muxed
                        else enc.codec_string),
                frame_rate=fps,
                audio_group=("" if ts_mode else
                             (f"aud{rung.audio_bitrate // 1000}"
                              if rung.audio_bitrate else ""))))
        atomic_write_text(out / "master.m3u8", hls.master_playlist(variants))
        if not ts_mode:      # DASH is CMAF-only; TS serves HLS alone
            atomic_write_text(out / "manifest.mpd", hls.dash_manifest(
                variants, duration_s=duration_s,
                segment_duration_s=plan.segment_duration_s))
        return results, variants

    # ------------------------------------------------------------------
    def _scan_resume_candidates(self, plan, out, init_matched
                                ) -> dict[str, list[int]]:
        """Per-rung timescale durations of the contiguous valid segments
        on disk; a rung whose init segment did not match restarts."""
        per_rung = {}
        for r in plan.rungs:
            existing = self._existing_segments(out / r.name)
            if existing and not init_matched.get(r.name, False):
                existing = []
            per_rung[r.name] = existing
        return per_rung

    @staticmethod
    def _apply_resume_state(plan, per_rung, start_segment, timescale,
                            seg_durs, bytes_written) -> None:
        """Install the resumed prefix into the run's per-rung state."""
        for rung in plan.rungs:
            durs = per_rung[rung.name][:start_segment]
            seg_durs[rung.name] = [d / timescale for d in durs]
            for i in range(start_segment):
                seg = plan.out_dir / rung.name / f"segment_{i + 1:05d}.m4s"
                bytes_written[rung.name] += seg.stat().st_size

    @staticmethod
    def _existing_segments(rdir: Path) -> list[int]:
        """Timescale durations of the contiguous valid segments: one
        counts only if its moof parses and carries samples."""
        durations: list[int] = []
        if not (rdir / "init.mp4").exists():
            return durations
        i = 0
        while True:
            seg = rdir / f"segment_{i + 1:05d}.m4s"
            if not seg.exists() or seg.stat().st_size < 16:
                break
            try:
                with open(seg, "rb") as fp:
                    tree = parse_box_tree(fp)
                moof = next(b for b in tree if b.type == "moof")
                trun = moof.find("traf", "trun")
                n = int.from_bytes(trun.payload[4:8], "big")
                if n == 0:
                    break
                # trun payload: ver/flags, count, data_offset, then
                # (duration, size, flags, cts) per sample
                dur = sum(int.from_bytes(trun.payload[12 + 16 * k:16 + 16 * k],
                                         "big") for k in range(n))
            except (StopIteration, AttributeError, ValueError, IndexError):
                break  # torn write
            durations.append(dur)
            i += 1
        return durations

    def _thumbnail_planes(self, y, u, v, max_width: int = 1280):
        """One frame's planes on the device, resized (the fused kernel on
        CUDA) to at most ``max_width`` wide; each geometry's matrices are
        built once per backend, so the kernel's band form is too."""
        y, u, v = (torch.tensor(p, device=self.device) for p in (y, u, v))
        h, w = y.shape
        if w <= max_width:
            return y, u, v
        th = max(2, round(h * max_width / w / 2) * 2)
        key = (h, w, th, max_width)
        if key not in self._thumb_mats:
            self._thumb_mats[key] = mats_from_numpy(ladder_matrices(
                (("thumb", th, max_width, 0),), h, w), self.device)["thumb"]
        return tuple(p[0] for p in resize_yuv420(
            y[None], u[None], v[None], self._thumb_mats[key]))

    @staticmethod
    def _thumbnail_blocks(y, u, v) -> JpegBlocks:
        """The thumbnail's quantized JPEG blocks from its resized planes:
        BT.709 RGB truncated to bytes, quality 85."""
        rgb = yuv420_to_rgb(y, u, v, standard="bt709")
        return quantize_rgb((rgb * 255).to(torch.uint8), quality=85)

    def _write_thumbnail(self, y, u, v, path: str,
                         max_width: int = 1280) -> None:
        """JPEG of one frame, at most ``max_width`` wide."""
        blocks = self._thumbnail_blocks(*self._thumbnail_planes(y, u, v,
                                                                max_width))
        atomic_write_bytes(Path(path), pack_jpeg(blocks))


register_backend("torch", TorchBackend)
