"""The ladder run of every codec path, written once: the rung outputs
(:class:`RungOutputs`: directories and init segments, segments, resume
from the segments on disk, the thumbnail, the playlists and manifests)
and the host pipeline of one run (:class:`LadderRun`: the stage profile,
the executor, progress, the dispatch loop of a device ladder program and
the result). The codec paths (``torch_backend.py`` for H.264,
``hevc_path.py``, ``av1_path.py``) give it only what differs: segment
bytes, each rung's ``process``, and for a device program its output
keys, a batch's lead shape, its dispatch arguments and its decode
prefetch depth. Nothing here looks at the codec.

The stages overlap through ``parallel/executor.py``: a prefetch thread
reads or decodes the next batches, the dispatch thread queues each
batch's program on the run's compute streams and starts its
device-to-host copies, one consumer thread per rung entropy-codes and
packages its rung in batch order, and ``VLOG_PIPELINE_DEPTH`` batches
are in flight. Rate control follows the reference: observations of
batch k apply before dispatch of batch k + depth, and right after each
batch while a controller is hunting, so every depth plans the same QPs.
Each dispatch leaves a record in ``RunResult.dispatches`` (the
executor's ``timed_dispatch``), and the dispatch thread's steps are
``stage`` spans (README's port section). ``RunResult.stage_s`` has the
reference's keys (the busy seconds of ``decode_wait_s``,
``compute_wait_s``, ``device_pull_s``, ``entropy_s`` and ``package_s``,
``pad_frames``, ``rung_<name>_s`` and the executor's gauges) and the
port's ``enqueue_s`` and ``dispatch_wall_s``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable

import numpy as np

from vlog_tpu_torch.backends.base import THUMBNAIL_NAME, RungResult, RunResult
from vlog_tpu_torch.media import hls
from vlog_tpu_torch.media.boxes import parse_box_tree
from vlog_tpu_torch.media.fmp4 import Sample
from vlog_tpu_torch.obs.trace import STAGE_KEYS, stage
from vlog_tpu_torch.parallel.executor import (DecodePrefetch,
                                              PipelineExecutor,
                                              dispatch_streams)
from vlog_tpu_torch.parallel.scheduler import (host_pool_for_run,
                                               placement_for_run)
from vlog_tpu_torch.utils.fsio import (atomic_write_bytes, atomic_write_text,
                                       prepare_init_segment)


def dispatch_geometry(default_device, plan, rungs_spec, clen: int):
    """``(device, grid, data, chains_per, batch_n)``: the lease's first
    device and grid under the scheduler, else ``default_device``; whole
    chains of ``clen`` frames per dispatch, enough for
    ``plan.frame_batch`` frames, rounded up to the grid's data width only,
    so every grid whose data width divides the batch stages the same
    batches."""
    hint = max(1, -(-plan.frame_batch // clen))
    dev, grid = placement_for_run(default_device, rungs_spec, hint)
    data = grid.data if grid is not None else 1
    chains_per = max(data, hint + (-hint) % data)
    return dev, grid, data, chains_per, clen * chains_per


def psnr_y(sse: np.ndarray, npix: int) -> np.ndarray:
    """Luma PSNR from per-frame squared error over ``npix`` pixels (99 dB
    for a lossless frame)."""
    mse = np.maximum(sse / npix, 1e-12)
    return np.where(mse < 1e-9, 99.0, 10 * np.log10(255 ** 2 / mse))


def _existing_segments(rdir: Path) -> list[int]:
    """Timescale durations of the contiguous valid segments: one counts
    only if its moof parses and carries samples."""
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


class RungOutputs:
    """Every rung's output of one run under ``plan.out_dir``: its
    directory and init segment, its coded samples until a segment is
    whole, the segments written (durations and bytes) and its PSNRs.

    ``segment_bytes(rung, index, base_time, chunk)`` is the codec path's
    segment of ``chunk`` (1-based ``index``, ``base_time`` in timescale
    units). Each rung's state is touched only by that rung's consumer
    thread."""

    def __init__(self, plan, segment_bytes: Callable[..., bytes]):
        self.plan = plan
        self.out = Path(plan.out_dir)
        self._ts_mode = plan.streaming_format == "hls_ts"
        self._ext = "ts" if self._ts_mode else "m4s"
        self.timescale = plan.fps_num * 1000
        self.frame_dur = plan.fps_den * 1000
        fps = plan.fps_num / plan.fps_den
        self.frames_per_seg = max(1, round(plan.segment_duration_s * fps))
        self._segment_bytes = segment_bytes
        self._rungs = {r.name: r for r in plan.rungs}
        self._seg_durs: dict[str, list[float]] = {n: [] for n in self._rungs}
        self._bytes = dict.fromkeys(self._rungs, 0)
        self._psnr: dict[str, list[float]] = {n: [] for n in self._rungs}
        self._pending: dict[str, list[Sample]] = {n: [] for n in self._rungs}
        self._init_matched: dict[str, bool] = {}
        self._on_disk: dict[str, list[int]] = {}
        self.start_segment = 0
        self.thumbnail_path: str | None = None
        self.out.mkdir(parents=True, exist_ok=True)

    @property
    def start_frame(self) -> int:
        return self.start_segment * self.frames_per_seg

    def open(self, rung, init: bytes | None, config_tag: str) -> None:
        """Make the rung's directory and (CMAF; ``init`` None for TS)
        write its init segment, noting whether the one on disk already
        matched."""
        rdir = self.out / rung.name
        rdir.mkdir(parents=True, exist_ok=True)
        if init is not None:
            self._init_matched[rung.name] = prepare_init_segment(
                rdir, init, config_tag=config_tag)

    def resumable(self) -> int:
        """How many segments every rung already has on disk: contiguous,
        valid, behind an init segment this run matched (a rung whose init
        did not match restarts)."""
        self._on_disk = {
            n: (_existing_segments(self.out / n)
                if self._init_matched.get(n, False) else [])
            for n in self._rungs}
        return min(len(d) for d in self._on_disk.values())

    def resume(self, start_segment: int) -> None:
        """Take each rung's first ``start_segment`` segments from disk (at
        most :meth:`resumable`); a resumed run keeps the tree's original
        first-frame thumbnail."""
        self.start_segment = start_segment
        if start_segment == 0:
            return
        for name in self._rungs:
            durs = self._on_disk[name][:start_segment]
            self._seg_durs[name] = [d / self.timescale for d in durs]
            for i in range(start_segment):
                seg = self.out / name / f"segment_{i + 1:05d}.m4s"
                self._bytes[name] += seg.stat().st_size
        if self.plan.thumbnail and (self.out / THUMBNAIL_NAME).exists():
            self.thumbnail_path = str(self.out / THUMBNAIL_NAME)

    def thumbnail(self, pipe: PipelineExecutor, write: Callable,
                  planes, device) -> None:
        """Queue the first batch's first frame as the tree's thumbnail, on
        the host pool, unless the run has one."""
        if self.plan.thumbnail and self.thumbnail_path is None:
            self.thumbnail_path = str(self.out / THUMBNAIL_NAME)
            pipe.submit_aux(write, *(p[0] for p in planes),
                            self.thumbnail_path, 1280, device)

    def queue(self, name: str, data: bytes, is_sync: bool,
              psnr: float | None = None) -> None:
        """One coded frame of the rung, in display order."""
        self._pending[name].append(Sample(data=data, duration=self.frame_dur,
                                         is_sync=is_sync))
        if psnr is not None:
            self._psnr[name].append(psnr)

    def _write(self, name: str, chunk: list[Sample]) -> None:
        durs = self._seg_durs[name]
        idx = len(durs) + 1
        data = self._segment_bytes(self._rungs[name], idx,
                                   int(round(sum(durs) * self.timescale)),
                                   chunk)
        atomic_write_bytes(self.out / name / f"segment_{idx:05d}.{self._ext}",
                           data)
        durs.append(sum(s.duration for s in chunk) / self.timescale)
        self._bytes[name] += len(data)

    def write_whole(self, name: str, prof_add: Callable) -> None:
        """Write the rung's whole segments (timed as ``package_s``)."""
        tw = time.perf_counter()
        pending = self._pending[name]
        while len(pending) >= self.frames_per_seg:
            self._write(name, pending[:self.frames_per_seg])
            del pending[:self.frames_per_seg]
        prof_add("package_s", time.perf_counter() - tw)

    def write_rest(self) -> None:
        """Write each rung's trailing partial segment."""
        for name, pending in self._pending.items():
            if pending:
                self._write(name, pending)
                self._pending[name] = []

    def publish(self, codecs: dict[str, str], duration_s: float):
        """Write each rung's media playlist, ``master.m3u8`` and (CMAF)
        ``manifest.mpd``; returns the rung results and the variants.
        ``codecs`` maps each rung to its codec string."""
        plan, out, ts_mode = self.plan, self.out, self._ts_mode
        fps = plan.fps_num / plan.fps_den
        audio_by_rate = plan.audio_adts or {}
        results, variants = [], []
        for rung in plan.rungs:
            name = rung.name
            playlist = hls.media_playlist(
                [hls.SegmentRef(uri=f"segment_{i + 1:05d}.{self._ext}",
                                duration_s=d)
                 for i, d in enumerate(self._seg_durs[name])],
                target_duration_s=plan.segment_duration_s,
                init_uri=None if ts_mode else "init.mp4")
            ppath = out / name / "playlist.m3u8"
            atomic_write_text(ppath, playlist)
            total_dur = sum(self._seg_durs[name])
            nbytes = self._bytes[name]
            achieved = int(nbytes * 8 / total_dur) if total_dur else 0
            psnr = self._psnr[name]
            results.append(RungResult(
                name=name, width=rung.width, height=rung.height,
                codec_string=codecs[name],
                segment_count=len(self._seg_durs[name]), bytes_written=nbytes,
                mean_psnr_y=float(np.mean(psnr)) if psnr else None,
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
                codecs=(codecs[name] + ",mp4a.40.2" if muxed
                        else codecs[name]),
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


class LadderRun:
    """The host pipeline of one run, a context that closes its executor:
    the stage profile (``prof``, obs/trace.py ``STAGE_KEYS`` plus the
    executor's gauges), the :class:`PipelineExecutor` whose rung
    consumers ``pull`` each rung's host data and run the codec path's
    ``process(name, batch, host)``, and after each batch
    ``progress_cb(frames_done, *report(frames_done))`` (``report`` gives
    the total and the message). The defaults pull a device program's
    outputs."""

    def __init__(self, plan, outputs: RungOutputs, src, process: Callable, *,
                 progress_cb, report: Callable[[int], tuple[int, str]],
                 pull: Callable = lambda name, batch: batch.d2h.host(name),
                 ready: Callable | None = lambda b: b.d2h.wait_compute()):
        self.plan, self.outputs, self.src = plan, outputs, src
        self.prof = dict.fromkeys(STAGE_KEYS, 0.0)
        self.frames_done = outputs.start_frame
        self._progress_cb, self._report = progress_cb, report
        self.pipe = PipelineExecutor(
            [r.name for r in plan.rungs], pull=pull, process=process,
            ready=ready, on_batch_done=self._batch_done,
            host_pool=host_pool_for_run(),   # shared across slot jobs
            prof=self.prof, name="vlog-pipe")

    def __enter__(self) -> LadderRun:
        return self

    def __exit__(self, *exc) -> None:
        self.pipe.close()

    def _batch_done(self, batch) -> None:
        # serialized and in batch order (the executor's contract)
        self.frames_done += batch.n_real
        if self._progress_cb:
            self._progress_cb(self.frames_done,
                              *self._report(self.frames_done))

    def dispatch(self, prog, rc, *, batch_n: int, prefetch: int,
                 keys: tuple[str, ...], lead: Callable[[int], tuple],
                 plan_args: Callable[[tuple], tuple],
                 write_thumbnail: Callable, device) -> None:
        """Run every batch of the source through the device program
        ``prog`` and the rung consumers, then write the trailing partial
        segments. ``lead(n_real)`` is the lead shape a batch of
        ``n_real`` frames is padded to (copies of its last frame, dropped
        after encode); ``plan_args(lead)`` the arguments of
        ``prog.dispatch`` after the planes, the first one each rung's QP
        plan; ``keys`` the outputs the consumers pull. ``rc`` is the
        run's :class:`~vlog_tpu_torch.parallel.executor.LaggedRateControl`
        and ``prefetch`` the depth of the decode prefetch."""
        pipe, prof, rungs = self.pipe, self.prof, self.plan.rungs
        feed = None
        try:
            feed = DecodePrefetch(self.src, batch_n, self.outputs.start_frame,
                                  maxsize=prefetch)
            batch_idx = 0
            with dispatch_streams(prog.devices):
                while True:
                    td = time.perf_counter()
                    with stage("executor.decode_wait"):
                        item = feed.get()
                    prof["decode_wait_s"] += time.perf_counter() - td
                    if item is None:
                        break
                    n_real = item[0].shape[0]
                    self.outputs.thumbnail(pipe, write_thumbnail, item,
                                           device)
                    shape = lead(n_real)
                    n_disp = int(np.prod(shape))
                    # backpressure before planning: batches <= N-depth are
                    # consumed, so every depth plans the same QPs
                    with stage("executor.reserve"):
                        pipe.reserve()
                    with stage("executor.plan"):
                        rc.apply_upto(batch_idx - pipe.depth)
                        pipe.note_pad_waste(n_real, n_disp)
                        planes = [(np.concatenate(
                            [p, np.repeat(p[-1:], n_disp - n_real, 0)])
                            if n_disp > n_real else p)
                            .reshape(shape + p.shape[1:]) for p in item]
                        args = plan_args(shape)
                    # each column stages the batch on its devices and
                    # leaves its rungs' outputs there
                    with stage("executor.dispatch"), \
                            pipe.timed_dispatch(n_disp, prog.devices) as rec:
                        outs = prog.dispatch(*planes, *args)
                    with stage("executor.submit"):
                        pipe.submit({r.name: {k: outs[r.name][k] for k in keys}
                                     for r in rungs}, n_real, args[0],
                                    record=rec)
                    del outs, planes
                    batch_idx += 1
                    if rc.hunting():
                        # calibration or cliff hunt: drain to depth 0 so
                        # every correction lands before the next batch
                        pipe.drain()
                        rc.apply_upto(batch_idx - 1)
                pipe.drain()
            self.outputs.write_rest()
        finally:
            if feed is not None:
                feed.close()

    def result(self, codecs: dict[str, str], *, t0: float,
               gop_len: int) -> RunResult:
        """Publish the tree's playlists and manifests; the run's result
        (``t0``: the run's start on the monotonic clock)."""
        plan, src = self.plan, self.src
        # an inexact (libav) source's frame count is an estimate: trust
        # the frames actually decoded
        frames = src.frame_count if src.exact_seek else self.frames_done
        fps = plan.fps_num / plan.fps_den
        duration_s = frames / fps if fps else 0.0
        results, variants = self.outputs.publish(codecs, duration_s)
        return RunResult(
            rungs=results, frames_processed=self.frames_done,
            duration_s=duration_s, thumbnail_path=self.outputs.thumbnail_path,
            wall_s=time.monotonic() - t0, variants=variants, fps=fps,
            segment_duration_s=plan.segment_duration_s,
            stage_s={k: round(v, 3) for k, v in self.prof.items()}
            | self.pipe.gauges(),
            gop_len=gop_len,
            resumed_segments=self.outputs.start_segment * len(plan.rungs),
            dispatches=self.pipe.dispatches)
