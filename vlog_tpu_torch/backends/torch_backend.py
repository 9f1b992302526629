"""The PyTorch/CUDA ladder backend: a source in, an HLS tree out (port of
the H.264 path of ``vlog_tpu/backends/jax_backend.py``).

:meth:`TorchBackend.run` runs ``codec="h265"`` (or ``"hevc"``) on the
HEVC path (backends/hevc_path.py, CMAF only), ``codec="av1"`` on the
delegated AV1 encode (backends/av1_path.py, CMAF only: the resize
kernel on the device, the system AV1 encoder through the libav shim),
and H.264 here. The batch loop, the rung outputs, resume and publish
are backends/ladder_run.py's; this module gives them H.264's part.

Sources open through ``backends/source.py::open_source``: Y4M, an MP4 in
the first-party H.264 envelope (decoded on the backend's device), or a
foreign file through the libav shim. Per dispatch batch: host read or
decode -> device ladder program (parallel/ladder.py: the resize kernel,
then I+P chains with deblocking and in-chain rate adaptation, or
intra-only frames) -> device-to-host copy of int16 levels (and MVs) ->
host CABAC or CAVLC (native) -> segments. Output per rung, CMAF
(default):

    {out}/{rung}/init.mp4, encoder.tag, segment_%05d.m4s, playlist.m3u8

plus ``master.m3u8``, ``manifest.mpd``, ``rc_journal.jsonl`` and
``thumbnail.jpg`` at the root. ``streaming_format="hls_ts"`` writes
``segment_%05d.ts`` (ADTS audio muxed in when the plan carries it) and
no init segment, DASH manifest or journal.

H.264's part: the encoders and ``avc1`` tracks, the MPEG-TS muxing, the
two program kinds (I+P chains, whose I frames take the -2 QP anchor on
the host, and intra frames), each rung's entropy coding
(``process_chain``, ``process_intra``), the thumbnail, and the
rate-control journal, which both backends write alike. A CMAF run
resumes from the segments on disk (``run(..., resume=True)``, the
default) at a batch boundary the journal can replay, so the resumed tree
equals the uninterrupted one, whichever backend wrote its first part; a
libav source (no frame-exact seek) never resumes. Under the mesh
scheduler a lease wider than one device lays the ladder out as its
(data x rung) grid (``VLOG_TPU_MESH``, ``parallel/ladder.py::
GridProgram``); decode and the thumbnail stay on its first device. A
dispatch whose real frames fill fewer chains than the batch holds (the
source's tail) encodes only the chains that hold real frames, and a
lone partial chain only up to its last real frame: the JAX program
encodes the replicated padding too and drops it, so the bytes are the
same.
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
    RunResult,
    plan_rung_geometry,
    register_backend,
)
from vlog_tpu_torch.backends.av1_path import run_av1
from vlog_tpu_torch.backends.hevc_path import run_hevc
from vlog_tpu_torch.backends.ladder_run import (LadderRun, RungOutputs,
                                                dispatch_geometry, psnr_y)
from vlog_tpu_torch.backends.rate_control import RateController
from vlog_tpu_torch.backends.source import open_source
from vlog_tpu_torch.codecs.h264.api import H264Encoder
from vlog_tpu_torch.codecs.h264.encoder import FrameLevels
from vlog_tpu_torch.codecs.jpeg.encoder import (JpegBlocks, pack_jpeg,
                                                quantize_rgb)
from vlog_tpu_torch.device import resolve_device
from vlog_tpu_torch.media.fmp4 import (Sample, TrackConfig, avc1_sample_entry,
                                       init_segment, media_segment)
from vlog_tpu_torch.media.probe import VideoInfo
from vlog_tpu_torch.media.ts import TsMuxer, TsSample
from vlog_tpu_torch.media.y4m import fps_to_fraction
from vlog_tpu_torch.ops.colorspace import yuv420_to_rgb
from vlog_tpu_torch.ops.fused_resize import resize_yuv420
from vlog_tpu_torch.parallel.compile_cache import ensure_compile_cache
from vlog_tpu_torch.parallel.executor import LaggedRateControl
from vlog_tpu_torch.parallel.ladder import (ladder_chain_grid,
                                            ladder_encode_grid,
                                            ladder_matrices, mats_from_numpy)
from vlog_tpu_torch.parallel.mesh import visible_cuda_devices
from vlog_tpu_torch.utils import failpoints
from vlog_tpu_torch.utils.fsio import atomic_write_bytes

_CHAIN_KEYS = ("i_luma_dc", "i_luma_ac", "i_chroma_dc", "i_chroma_ac",
               "p_luma", "p_chroma_dc", "p_chroma_ac", "mv", "sse_y",
               "qp_eff", "cost")
_INTRA_KEYS = ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac", "sse_y")


class TorchBackend:
    """Runs the one-pass H.264 or HEVC ladder on ``device`` (default
    ``"cuda"``: every visible card without a lease), or on its slot
    lease's devices under the mesh scheduler."""

    name = "torch"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        # (h, w, th, tw, device) -> the thumbnail's matrices
        self._thumb_mats = {}

    def detect(self) -> Capabilities:
        """What this backend's device offers; raises on a CUDA device when
        CUDA is missing."""
        dev = resolve_device(self.device)
        if dev.type == "cuda":
            props = torch.cuda.get_device_properties(dev)
            kind, count, mem = ("gpu", len(visible_cuda_devices()),
                                props.total_memory)
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
        if codec not in ("h264", "h265", "av1"):
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
        if any(r.codec == "av1" for r in plan.rungs):
            return run_av1(self, plan, progress_cb, resume, t0)
        fps = plan.fps_num / plan.fps_den
        ts_mode = plan.streaming_format == "hls_ts"
        clen = plan.gop_len
        chain_mode = clen > 1
        # chains run the in-loop deblocking filter; intra frames do not
        deblock = config.H264_DEBLOCK and chain_mode
        tag = f"h264:{config.H264_ENTROPY}:deblock={int(deblock)}"
        rungs_spec = tuple((r.name, r.height, r.width, r.qp)
                           for r in plan.rungs)
        dev, grid, data, chains_per, batch_n = dispatch_geometry(
            self.device, plan, rungs_spec, clen)
        ensure_compile_cache()

        # MPEG-TS: one muxer per rung for the whole playlist (a TS run
        # never resumes: its continuity counters span the playlist),
        # exact 90 kHz timestamps (multiply before dividing, per index)
        audio_by_rate = plan.audio_adts or {}
        ts_muxers: dict[str, TsMuxer] = {}
        ts_frame_idx = {r.name: 0 for r in plan.rungs}
        ts_audio_idx = {r.name: 0 for r in plan.rungs}

        def vpts(idx: int) -> int:
            return idx * 90000 * plan.fps_den // plan.fps_num

        def apts(idx: int, sr: int) -> int:
            return idx * 90000 * 1024 // sr

        def segment_bytes(rung, index: int, base_time: int,
                          chunk: list[Sample]) -> bytes:
            name = rung.name
            if not ts_mode:
                return media_segment(tracks[name], index, base_time, chunk)
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

        outputs = RungOutputs(plan, segment_bytes)
        frames_per_seg = outputs.frames_per_seg
        encoders, tracks = {}, {}
        for rung in plan.rungs:
            enc = encoders[rung.name] = H264Encoder(
                width=rung.width, height=rung.height, fps_num=plan.fps_num,
                fps_den=plan.fps_den, qp=rung.qp,
                entropy=config.H264_ENTROPY, deblock=deblock)
            tracks[rung.name] = TrackConfig(
                track_id=1, handler="vide", timescale=outputs.timescale,
                sample_entry=avc1_sample_entry(rung.width, rung.height,
                                               enc.avcc_config),
                width=rung.width, height=rung.height)
            outputs.open(rung, None if ts_mode else init_segment(
                tracks[rung.name]), config_tag=f"{tag}:gop={clen}")

        src = open_source(plan.source.path, dev)
        journal = None
        try:
            total = src.frame_count
            # resume candidate: the first segment any rung is missing (TS
            # restarts from 0; a libav source seeks only to keyframes)
            start_segment = (outputs.resumable()
                             if resume and not ts_mode and src.exact_seek
                             else 0)

            src_h, src_w = plan.source.height, plan.source.width
            if chain_mode:
                prog = ladder_chain_grid(
                    rungs_spec, src_h, src_w,
                    search=config.MOTION_SEARCH_RADIUS, grid=grid,
                    deblock=deblock, device=dev)
            else:
                prog = ladder_encode_grid(rungs_spec, src_h, src_w, grid,
                                          device=dev)
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
                jpath = plan.out_dir / rcj.RC_JOURNAL_NAME
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
                journal = rcj.RCJournal(jpath, header,
                                        keep_batches=start_batch)
            outputs.resume(start_segment)
            for enc in encoders.values():
                enc.start_at(outputs.start_frame, clen)
            npix = {r.name: r.height * r.width for r in plan.rungs}

            def finish(name: str, batch_index: int, frames,
                       batch_bytes: int, n_frames: int, rc_mix,
                       cost) -> None:
                """Queue a rung's coded frames, post its rate observation
                (and journal it), write the segments that are whole."""
                for ef in frames:
                    outputs.queue(name, ef.annexb if ts_mode else ef.avcc,
                                  ef.is_idr, ef.psnr_y)
                rc.post(name, batch_index, nbytes=batch_bytes,
                        frames=n_frames, frame_qps=rc_mix, cost=cost)
                if journal is not None:
                    journal.record(batch_index, name, nbytes=batch_bytes,
                                   frames=n_frames, qps=rc_mix, cost=cost)
                outputs.write_whole(name, ladder.pipe.prof_add)

            def process_chain(name: str, batch, host: dict) -> None:
                """Entropy-code one rung of a dispatch of chains (display
                order is chain-major)."""
                i32 = lambda a: np.ascontiguousarray(a, np.int32)  # noqa: E731
                n_real, plan_q = batch.n_real, batch.qps[name]
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
                        psnr_y(sse[ci, :keep], npix[name]),
                        pool=ladder.pipe.host_pool)
                    n_frames += keep
                rc_mix = np.concatenate(rc_qs) if rc_qs else None
                if rc_mix is not None and rc_mix.size == 0:
                    rc_mix = None
                ladder.pipe.prof_add("entropy_s", time.perf_counter() - te)
                finish(name, batch.index, frames,
                       sum(len(ef.avcc) for ef in frames), max(n_frames, 1),
                       rc_mix, cost_sum)

            def process_intra(name: str, batch, host: dict) -> None:
                """Entropy-code one rung of a dispatch of intra frames."""
                n_real = batch.n_real
                te = time.perf_counter()
                levels = {k: np.ascontiguousarray(host[k][:n_real], np.int32)
                          for k in _INTRA_KEYS[:4]}
                q_used = batch.qps[name][:n_real]
                frames = encoders[name].encode_levels(
                    levels, q_used, psnr_y(host["sse_y"][:n_real], npix[name]),
                    pool=ladder.pipe.host_pool)
                ladder.pipe.prof_add("entropy_s", time.perf_counter() - te)
                finish(name, batch.index, frames,
                       sum(len(ef.avcc) for ef in frames), n_real, q_used,
                       None)

            def chain_lead(n_real: int) -> tuple[int, int]:
                # only the chains holding real frames (a lone chain only
                # up to its last real frame, >= 2), padded to the data width
                real = -(-n_real // clen)
                return (real + (-real) % data,
                        clen if real > 1 else max(2, n_real))

            def chain_args(lead: tuple[int, int]) -> tuple[dict, dict]:
                qps = {}
                for r in plan.rungs:
                    # the I frames take the -2 QP anchor
                    q = controllers[r.name].frame_qps(batch_n).reshape(
                        chains_per, clen)
                    q[:, 0] = np.maximum(q[:, 0] - 2, 0)
                    qps[r.name] = np.ascontiguousarray(q[:lead[0], :lead[1]])
                return qps, {r.name: controllers[r.name].device_rc_params()
                             for r in plan.rungs}

            def intra_args(lead: tuple[int]) -> tuple[dict]:
                return ({r.name: controllers[r.name].frame_qps(batch_n)
                         for r in plan.rungs},)

            with LadderRun(
                    plan, outputs, src,
                    process_chain if chain_mode else process_intra,
                    progress_cb=progress_cb,
                    report=lambda n: (total, f"encoded {n}/{total} frames"),
            ) as ladder:
                ladder.dispatch(
                    prog, rc, batch_n=batch_n, prefetch=2,
                    keys=_CHAIN_KEYS if chain_mode else _INTRA_KEYS,
                    lead=chain_lead if chain_mode else lambda n: (batch_n,),
                    plan_args=chain_args if chain_mode else intra_args,
                    write_thumbnail=self._write_thumbnail, device=dev)
        finally:
            src.close()
            if journal is not None:
                journal.close()
        return ladder.result({r.name: encoders[r.name].codec_string
                              for r in plan.rungs}, t0=t0, gop_len=clen)

    def _thumbnail_planes(self, y, u, v, max_width: int = 1280,
                          device: torch.device | None = None):
        """One frame's planes on ``device`` (default the backend's),
        resized (the fused kernel on CUDA) to at most ``max_width`` wide;
        each geometry's matrices are built once per backend and device,
        so the kernel's band form is too."""
        device = self.device if device is None else device
        y, u, v = (torch.tensor(p, device=device) for p in (y, u, v))
        h, w = y.shape
        if w <= max_width:
            return y, u, v
        th = max(2, round(h * max_width / w / 2) * 2)
        key = (h, w, th, max_width, str(device))
        if key not in self._thumb_mats:
            self._thumb_mats[key] = mats_from_numpy(ladder_matrices(
                (("thumb", th, max_width, 0),), h, w), device)["thumb"]
        return tuple(p[0] for p in resize_yuv420(
            y[None], u[None], v[None], self._thumb_mats[key]))

    @staticmethod
    def _thumbnail_blocks(y, u, v) -> JpegBlocks:
        """The thumbnail's quantized JPEG blocks from its resized planes:
        BT.709 RGB truncated to bytes, quality 85."""
        rgb = yuv420_to_rgb(y, u, v, standard="bt709")
        return quantize_rgb((rgb * 255).to(torch.uint8), quality=85)

    def _write_thumbnail(self, y, u, v, path: str, max_width: int = 1280,
                         device: torch.device | None = None) -> None:
        """JPEG of one frame, at most ``max_width`` wide, resized on
        ``device`` (default the backend's)."""
        blocks = self._thumbnail_blocks(*self._thumbnail_planes(
            y, u, v, max_width, device))
        atomic_write_bytes(Path(path), pack_jpeg(blocks))


register_backend("torch", TorchBackend)
