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

import numpy as np

import torch

from vlog_tpu_torch import config
from vlog_tpu_torch.backends.base import RunResult
from vlog_tpu_torch.backends.ladder_run import LadderRun, RungOutputs
from vlog_tpu_torch.backends.source import open_source
from vlog_tpu_torch.codecs.av1 import codec_string_from_tu, parse_seq_header
from vlog_tpu_torch.media.fmp4 import (
    TrackConfig,
    av01_sample_entry,
    av1c_record,
    init_segment,
    media_segment,
)
from vlog_tpu_torch.native.build import get_av_lib
from vlog_tpu_torch.ops.fused_resize import resize_yuv420
from vlog_tpu_torch.parallel.compile_cache import ensure_compile_cache
from vlog_tpu_torch.parallel.executor import DecodePrefetch, dispatch_stream
from vlog_tpu_torch.parallel.ladder import ladder_matrices, mats_from_numpy
from vlog_tpu_torch.parallel.mesh import data_devices, pad_batch, shard_frames
from vlog_tpu_torch.parallel.scheduler import placement_for_run


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

    tracks: dict[str, TrackConfig] = {}
    outputs = RungOutputs(plan, lambda rung, index, base_time, chunk:
                          media_segment(tracks[rung.name], index, base_time,
                                        chunk))
    frames_per_seg = outputs.frames_per_seg
    encoders: dict[str, _ShimEncoder] = {}
    meta: dict[str, dict] = {}        # rung -> {profile, level, tier}
    frame_idx = {r.name: 0 for r in plan.rungs}

    def _close_all() -> None:
        for enc in encoders.values():
            enc.close()

    try:
        for rung in plan.rungs:
            encoders[rung.name] = _ShimEncoder(
                lib, rung.width, rung.height, plan.fps_num, plan.fps_den,
                rung.video_bitrate, frames_per_seg)
        src = open_source(plan.source.path, dev)
    except BaseException:
        _close_all()
        raise
    try:
        total = src.frame_count
        # resume: AV1 tracks are written by a third-party encoder whose
        # bitstream state we cannot reconstruct mid-stream — restart
        # clean (the tree is still atomically replaced per segment)
        ensure_compile_cache()
        batch_n = max(1, plan.frame_batch)

        def ensure_track(rung, first_tu: bytes) -> None:
            """Build the av01 track from the first keyframe TU's
            sequence header (libaom leaves extradata to the bitstream)."""
            if rung.name in tracks:
                return
            prof, level, tier = parse_seq_header(first_tu)
            meta[rung.name] = {"profile": prof, "level": level,
                               "tier": tier}
            tracks[rung.name] = TrackConfig(
                track_id=1, handler="vide", timescale=outputs.timescale,
                sample_entry=av01_sample_entry(
                    rung.width, rung.height,
                    av1c_record(prof, level, tier)),
                width=rung.width, height=rung.height)
            # AV1 never resumes (a third-party encoder's mid-stream
            # state is unreconstructable): always purge stale segments
            for seg in (outputs.out / rung.name).glob("segment_*.m4s"):
                seg.unlink(missing_ok=True)
            outputs.open(rung, init_segment(tracks[rung.name]),
                         config_tag=f"av1:delegated:gop={frames_per_seg}")

        next_pts: dict[str, int] = {r.name: 0 for r in plan.rungs}

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
                outputs.queue(rung.name, data, is_key)
            outputs.write_whole(rung.name, ladder.pipe.prof_add)

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
            ladder.pipe.note_pad_waste(n, by.shape[0])
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
            ladder.pipe.prof_add("entropy_s", time.perf_counter() - te)

        # the delegated encoder has no separate device stage:
        # compute_wait_s stays 0, device_pull_s is the resize and its copy
        try:
            with LadderRun(plan, outputs, src, process,
                           progress_cb=progress_cb,
                           report=lambda n: (max(total, n), "av1 ladder"),
                           pull=pull, ready=None) as ladder:
                prefetch = None
                try:
                    # the reference's one-batch decode prefetch
                    prefetch = DecodePrefetch(src, batch_n, 0, maxsize=1)
                    while True:
                        td = time.perf_counter()
                        item = prefetch.get()
                        ladder.prof["decode_wait_s"] += (time.perf_counter()
                                                         - td)
                        if item is None:
                            break
                        outputs.thumbnail(ladder.pipe,
                                          backend._write_thumbnail, item, dev)
                        ladder.pipe.reserve()
                        ladder.pipe.submit(None, item[0].shape[0],
                                           extra=tuple(item))
                    ladder.pipe.drain()
                    for rung in plan.rungs:
                        drain(rung, encoders[rung.name].flush())
                    outputs.write_rest()
                finally:
                    if prefetch is not None:
                        prefetch.close()
        finally:
            _close_all()
    finally:
        src.close()
    return ladder.result({r.name: codec_string_from_tu(meta.get(r.name))
                          for r in plan.rungs}, t0=t0, gop_len=frames_per_seg)
