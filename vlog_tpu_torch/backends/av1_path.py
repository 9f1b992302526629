"""AV1 ladder execution path (codec="av1" re-encodes) — delegated encode
(port of ``vlog_tpu/backends/av1_path.py``).

Reference parity: AV1 in the reference is hardware-delegated encoding
(av1_vaapi selection, worker/hwaccel.py:555-646). This path draws the
same boundary: resize runs on the device (matmul lanczos), the AV1 bits
come from the system encoder libraries through the native shim
(native/av1enc.c — libaom-av1/SVT-AV1 via libavcodec), and the product
plane (CMAF av01 segments, playlists, resume validation, re-encode
flips) is all first-party and identical in shape to the H.264/HEVC
paths. H.264 and HEVC remain first-party device encoders; a first-party
AV1 entropy coder is out of scope (COVERAGE.md row 5).

In the port the device step is the per-rung resize, the fused resize
kernel (``ops/fused_resize.py::resize_yuv420``) on the run's device, or
on the rung's column of the lease's (data x rung) grid with the batch
padded to the column's data width and its frames sharded over the
column's devices; the resized planes come back to the host for the
encoder. The resize matrices are built once per run, rung and device.

The delegated encoder owns its own rate control (bitrate target per
rung, VBR); keyframes are forced at segment boundaries so the CMAF tree
stays chain-aligned and resumable.
"""

from __future__ import annotations

import ctypes
import time
from pathlib import Path

import numpy as np

import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.backends.base import THUMBNAIL_NAME, RungResult, RunResult
from vlog_tpu_torch.backends.source import open_source
from vlog_tpu_torch.codecs.av1 import codec_string_from_tu, parse_seq_header
from vlog_tpu_torch.media import hls
from vlog_tpu_torch.media.fmp4 import (
    Sample,
    TrackConfig,
    av01_sample_entry,
    av1c_record,
    init_segment,
    media_segment,
)
from vlog_tpu_torch.native.build import get_av_lib
from vlog_tpu_torch.ops.fused_resize import resize_yuv420
from vlog_tpu_torch.parallel.compile_cache import ensure_compile_cache
from vlog_tpu_torch.parallel.executor import (DecodePrefetch, PipelineExecutor,
                                              dispatch_stream)
from vlog_tpu_torch.parallel.ladder import ladder_matrices, mats_from_numpy
from vlog_tpu_torch.parallel.mesh import data_devices, pad_batch, shard_frames
from vlog_tpu_torch.parallel.scheduler import (host_pool_for_run,
                                               placement_for_run)
from vlog_tpu_torch.utils.fsio import (atomic_write_bytes, atomic_write_text,
                                       prepare_init_segment)


class Av1Unavailable(RuntimeError):
    """No system AV1 encoder (shim unbuildable or encoders absent)."""


class _ShimEncoder:
    """One delegated AV1 encoder instance (one per rung)."""

    def __init__(self, lib, w: int, h: int, fps_num: int, fps_den: int,
                 bitrate: int, gop_len: int):
        self.lib = lib
        self.w, self.h = w, h
        self.handle = lib.vt_av1_open(
            w, h, fps_num, fps_den,
            bitrate or 2_000_000, max(gop_len, 1),
            int(config.AV1_SPEED))
        if not self.handle:
            raise Av1Unavailable("vt_av1_open failed (no AV1 encoder)")
        self._out = np.empty(max(1 << 20, w * h * 2), np.uint8)
        self._u8p = ctypes.POINTER(ctypes.c_uint8)
        self._closed = False

    def send(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
             force_key: bool) -> None:
        p = self._u8p
        ya = np.ascontiguousarray(y, np.uint8)
        ua = np.ascontiguousarray(u, np.uint8)
        va = np.ascontiguousarray(v, np.uint8)
        rc = self.lib.vt_av1_send(
            self.handle, ya.ctypes.data_as(p), ua.ctypes.data_as(p),
            va.ctypes.data_as(p), 1 if force_key else 0)
        if rc != 0:
            raise RuntimeError(f"av1 send failed rc={rc}")

    def receive(self) -> list[tuple[bytes, bool, int]]:
        out = []
        is_key = ctypes.c_int()
        pts = ctypes.c_int64()
        while True:
            n = self.lib.vt_av1_receive(
                self.handle, self._out.ctypes.data_as(self._u8p),
                self._out.size, ctypes.byref(is_key), ctypes.byref(pts))
            if n == -2:    # grow and retry
                self._out = np.empty(self._out.size * 2, np.uint8)
                continue
            if n <= 0:
                if n == -3:
                    raise RuntimeError("av1 encoder error")
                return out
            out.append((self._out[:n].tobytes(), bool(is_key.value),
                        int(pts.value)))

    def flush(self) -> list[tuple[bytes, bool, int]]:
        self.lib.vt_av1_flush(self.handle)
        return self.receive()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.lib.vt_av1_close(self.handle)


def run_av1(backend, plan, progress_cb, resume: bool, t0: float
            ) -> RunResult:
    if plan.streaming_format != "cmaf":
        raise ValueError("av1 output is CMAF-only")
    lib = get_av_lib()
    if lib is None:
        raise Av1Unavailable(
            "AV1 re-encode needs the libav shim (system libavcodec with "
            "an AV1 encoder); it is unavailable or disabled")

    out = Path(plan.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    fps = plan.fps_num / plan.fps_den
    frames_per_seg = max(1, round(plan.segment_duration_s * fps))
    timescale = plan.fps_num * 1000
    frame_dur = plan.fps_den * 1000

    # Mesh parity with the first-party paths: rungs are partitioned
    # into cost-balanced columns of the 2-D (data x rung) grid and
    # each rung's device resize runs on its owning column (slot
    # submesh under the scheduler, all devices otherwise), so AV1
    # jobs can be placed on narrow slots too and per-rung resizes
    # land on distinct devices. Frames are independent, so sharded
    # and unsharded resizes are identical; pad_batch rounds the
    # batch up to the column's data width and the pull trims.
    rungs_spec = tuple((r.name, r.height, r.width, 0)
                       for r in plan.rungs)
    # the lease's first device and grid under the scheduler, else the
    # backend's device (every visible card for a generic "cuda")
    dev, grid = placement_for_run(backend.device, rungs_spec,
                                  plan.frame_batch)
    src_h, src_w = plan.source.height, plan.source.width
    mats: dict = {}            # (rung, device) -> its matrix tensors

    def resize_on(name: str, device, y, u, v):
        """One rung's resize of one block of frames on ``device`` (the
        kernel on CUDA), inside the device's compute stream; the
        planes come back to the host."""
        device = torch.device(device)
        key = (name, str(device))
        if key not in mats:
            rs = tuple(r for r in rungs_spec if r[0] == name)
            mats[key] = mats_from_numpy(
                ladder_matrices(rs, src_h, src_w), device)[name]
        with dispatch_stream(device):
            if not isinstance(y, torch.Tensor):
                y, u, v = (torch.from_numpy(np.ascontiguousarray(p))
                           .to(device) for p in (y, u, v))
            return tuple(p.cpu().numpy() for p in
                         resize_yuv420(y, u, v, mats[key]))

    encoders: dict[str, _ShimEncoder] = {}
    tracks: dict[str, TrackConfig] = {}
    meta: dict[str, dict] = {}        # rung -> {profile, level, tier}
    seg_counts: dict[str, int] = {}
    seg_durs: dict[str, list[float]] = {}
    bytes_written: dict[str, int] = {}
    pending: dict[str, list[Sample]] = {}
    frame_idx: dict[str, int] = {}

    def _close_all() -> None:
        for enc in encoders.values():
            enc.close()

    try:
        for rung in plan.rungs:
            encoders[rung.name] = _ShimEncoder(
                lib, rung.width, rung.height, plan.fps_num, plan.fps_den,
                rung.video_bitrate, frames_per_seg)
            seg_counts[rung.name] = 0
            seg_durs[rung.name] = []
            bytes_written[rung.name] = 0
            pending[rung.name] = []
            frame_idx[rung.name] = 0
        src = open_source(plan.source.path, dev)
    except BaseException:
        _close_all()
        raise
    try:
        total = src.frame_count
        # resume: AV1 tracks are written by a third-party encoder whose
        # bitstream state we cannot reconstruct mid-stream — restart
        # clean (the tree is still atomically replaced per segment)
        start_frame = 0

        ensure_compile_cache()

        batch_n = max(1, plan.frame_batch)
        # same stage fields as the first-party paths: device_pull is the
        # device resize + d2h, entropy the delegated encoder, package
        # the fMP4 segment writes (compute_wait stays 0 — the delegated
        # encoder has no separate async device stage)
        prof = {"decode_wait_s": 0.0, "compute_wait_s": 0.0,
                "device_pull_s": 0.0, "entropy_s": 0.0, "package_s": 0.0}

        frames_done = 0
        thumb_path = None

        def ensure_track(rung, first_tu: bytes) -> None:
            """Build the av01 track from the first keyframe TU's
            sequence header (libaom leaves extradata to the bitstream)."""
            if rung.name in tracks:
                return
            prof, level, tier = parse_seq_header(first_tu)
            meta[rung.name] = {"profile": prof, "level": level,
                               "tier": tier}
            tracks[rung.name] = TrackConfig(
                track_id=1, handler="vide", timescale=timescale,
                sample_entry=av01_sample_entry(
                    rung.width, rung.height,
                    av1c_record(prof, level, tier)),
                width=rung.width, height=rung.height)
            rdir = out / rung.name
            rdir.mkdir(parents=True, exist_ok=True)
            # AV1 never resumes (a third-party encoder's mid-stream
            # state is unreconstructable): always purge stale segments
            for seg in rdir.glob("segment_*.m4s"):
                seg.unlink(missing_ok=True)
            prepare_init_segment(
                rdir, init_segment(tracks[rung.name]),
                config_tag=f"av1:delegated:gop={frames_per_seg}")

        next_pts: dict[str, int] = {r.name: 0 for r in plan.rungs}

        def write_segment(rung, chunk: list[Sample]) -> None:
            name = rung.name
            idx = seg_counts[name]
            # base decode time = sum of durations of all prior segments
            base_time = int(round(sum(seg_durs[name]) * timescale))
            data = media_segment(tracks[name], idx + 1, base_time, chunk)
            atomic_write_bytes(out / name / f"segment_{idx + 1:05d}.m4s",
                               data)
            seg_counts[name] = idx + 1
            seg_durs[name].append(sum(s.duration for s in chunk) / timescale)
            bytes_written[name] += len(data)

        def drain(rung, pkts) -> None:
            for data, is_key, pts in pkts:
                # The muxer packages packets in arrival order with
                # uniform durations, and segment boundaries assume the
                # forced keyframes land where they were asked. Both
                # break silently if the encoder reorders or delays
                # output, so every encoder is opened low-delay
                # (av1enc.c) and this asserts the contract held.
                if pts != next_pts[rung.name]:
                    raise RuntimeError(
                        f"{rung.name}: delegated AV1 encoder emitted "
                        f"pts {pts}, expected {next_pts[rung.name]} — "
                        "out-of-order/delayed output breaks CMAF "
                        "timing (encoder not in low-delay mode?)")
                next_pts[rung.name] = pts + 1
                ensure_track(rung, data)
                pending[rung.name].append(
                    Sample(data=data, duration=frame_dur, is_sync=is_key))
            tw = time.perf_counter()
            while len(pending[rung.name]) >= frames_per_seg:
                chunk = pending[rung.name][:frames_per_seg]
                pending[rung.name] = pending[rung.name][frames_per_seg:]
                write_segment(rung, chunk)
            pipe.prof_add("package_s", time.perf_counter() - tw)

        # --- consume side on the shared stage-decoupled executor: the
        # delegated encoders are stateful and order-sensitive per rung
        # (the pts contract above), which is exactly the executor's
        # per-rung-ordered guarantee; rungs encode concurrently and up
        # to VLOG_PIPELINE_DEPTH decoded batches stay in flight.
        rungs_by_name = {r.name: r for r in plan.rungs}

        def pull(name, batch):
            rung = rungs_by_name[name]
            by, bu, bv = batch.extra
            if (rung.height, rung.width) == (by.shape[1], by.shape[2]):
                return by, bu, bv
            n = by.shape[0]
            if grid is None:
                return resize_on(name, dev, by, bu, bv)
            col = grid.column_of(name)
            (by, bu, bv), _ = pad_batch(grid.data, by, bu, bv)
            pipe.note_pad_waste(n, by.shape[0])
            # each data device resizes its contiguous block of frames
            shards = zip(data_devices(col.mesh),
                         *shard_frames(col.mesh, by, bu, bv))
            parts = [resize_on(name, d, y, u, v) for d, y, u, v in shards]
            return tuple(np.concatenate(p)[:n] for p in zip(*parts))

        def process(name, batch, host):
            rung = rungs_by_name[name]
            ry, ru, rv = host
            enc = encoders[name]
            te = time.perf_counter()
            for i in range(batch.n_real):
                fi = frame_idx[name]
                enc.send(ry[i], ru[i], rv[i],
                         force_key=(fi % frames_per_seg == 0))
                frame_idx[name] = fi + 1
                drain(rung, enc.receive())
            pipe.prof_add("entropy_s", time.perf_counter() - te)

        def on_batch_done(batch):
            # serialized + batch-ordered by the executor's contract
            nonlocal frames_done
            frames_done += batch.n_real
            if progress_cb is not None:
                progress_cb(frames_done, max(total, frames_done),
                            "av1 ladder")

        pipe = PipelineExecutor(
            [r.name for r in plan.rungs], pull=pull, process=process,
            on_batch_done=on_batch_done,
            host_pool=host_pool_for_run(),   # shared across slot executors
            prof=prof, name="vlog-pipe")

        prefetch = None
        try:
            # the reference's one-batch decode prefetch
            prefetch = DecodePrefetch(src, batch_n, start_frame, maxsize=1)
            while True:
                td = time.perf_counter()
                item = prefetch.get()
                prof["decode_wait_s"] += time.perf_counter() - td
                if item is None:
                    break
                by, bu, bv = item
                if plan.thumbnail and thumb_path is None:
                    # the first batch's first frame, on the host pool
                    thumb_path = str(out / THUMBNAIL_NAME)
                    pipe.submit_aux(backend._write_thumbnail, by[0],
                                    bu[0], bv[0], thumb_path, 1280, dev)
                pipe.reserve()
                pipe.submit(None, by.shape[0], extra=(by, bu, bv))
            pipe.drain()
            for rung in plan.rungs:
                drain(rung, encoders[rung.name].flush())
                if pending[rung.name]:
                    write_segment(rung, pending[rung.name])
                    pending[rung.name] = []
        finally:
            if prefetch is not None:
                prefetch.close()
            pipe.close()
            for enc in encoders.values():
                enc.close()
    finally:
        src.close()

    true_total = total if src.exact_seek else frames_done
    duration_s = true_total / fps if fps else 0.0
    results, variants = [], []
    for rung in plan.rungs:
        name = rung.name
        cstr = codec_string_from_tu(meta.get(name))
        playlist = hls.media_playlist(
            [hls.SegmentRef(uri=f"segment_{i + 1:05d}.m4s",
                            duration_s=seg_durs[name][i])
             for i in range(seg_counts[name])],
            target_duration_s=plan.segment_duration_s,
            init_uri="init.mp4")
        ppath = out / name / "playlist.m3u8"
        atomic_write_text(ppath, playlist)
        total_dur = sum(seg_durs[name])
        achieved = (int(bytes_written[name] * 8 / total_dur)
                    if total_dur else 0)
        results.append(RungResult(
            name=name, width=rung.width, height=rung.height,
            codec_string=cstr, segment_count=seg_counts[name],
            bytes_written=bytes_written[name], mean_psnr_y=None,
            achieved_bitrate=achieved, playlist_path=str(ppath),
            target_bitrate=rung.video_bitrate))
        variants.append(hls.VariantRef(
            name=name, uri=f"{name}/playlist.m3u8",
            bandwidth=max(achieved, 1), width=rung.width,
            height=rung.height, codecs=cstr, frame_rate=fps,
            audio_group=(f"aud{rung.audio_bitrate // 1000}"
                         if rung.audio_bitrate else "")))
    atomic_write_text(out / "master.m3u8", hls.master_playlist(variants))
    atomic_write_text(out / "manifest.mpd", hls.dash_manifest(
        variants, duration_s=duration_s,
        segment_duration_s=plan.segment_duration_s))
    return RunResult(
        rungs=results, frames_processed=frames_done,
        duration_s=duration_s, thumbnail_path=thumb_path,
        wall_s=time.monotonic() - t0, variants=variants, fps=fps,
        segment_duration_s=plan.segment_duration_s,
        stage_s={k: round(v, 3) for k, v in prof.items()} | pipe.gauges(),
        gop_len=frames_per_seg)
