"""The per-video processing pipeline (port of
``vlog_tpu/worker/pipeline.py``): probe, original, ladder, audio,
verify, manifest, with the backend and the AAC encoders' MDCT on one
torch device.

Steps (checkpointable by inspecting the output directory):
  1. probe         — media.probe.get_video_info
  2. original      — copy the upload next to the renditions
  3. ladder        — backend.run (thumbnail + segments + playlists); for
                     ``hls_ts`` the pipeline first encodes one ADTS stream
                     per distinct ladder audio rate, which the backend
                     muxes into every segment
  3b. audio        — CMAF: the AAC rendition group at the ladder's audio
                     bitrates, then master/DASH again with the audio
  4. verify        — validate master/media playlists + segment atoms,
                     achieved bitrate and reconstruction-quality gates
  4b. manifest     — outputs.json integrity manifest over the verified
                     tree, written last so it only ever describes
                     published files
  5. finalize      — summary for the DB/webhook layer
"""

from __future__ import annotations

import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from vlog_tpu_torch.backends import Backend, RunResult, select_backend
from vlog_tpu_torch.backends.base import ProgressFn
from vlog_tpu_torch.media import hls
from vlog_tpu_torch.media.probe import VideoInfo, get_video_info
from vlog_tpu_torch.utils.fsio import atomic_write_text


class VerificationError(RuntimeError):
    """Output failed post-transcode validation."""


def verify_output(master_path, run, *, expect_cmaf: bool) -> None:
    """Post-transcode gates: structural (playlists parse, segments carry
    the right atom types) plus the achieved bitrate within a sane band of
    the target and a reconstruction-quality floor. The thresholds catch
    *broken* output (runaway bits, garbage recon), not imperfect
    convergence: VBR legitimately overshoots on short content."""
    try:
        variant_results = hls.validate_master_playlist(master_path)
        for uri, res in variant_results.items():
            if res["cmaf"] != expect_cmaf:
                raise VerificationError(
                    f"{uri}: expected "
                    f"{'CMAF' if expect_cmaf else 'TS'} variant")
    except (hls.PlaylistValidationError, OSError) as exc:
        raise VerificationError(str(exc)) from exc
    for r in run.rungs:
        # The bitrate gate needs the control loop to have had a chance:
        # with fewer than ~5 segments the average is all calibration
        # transient and says nothing about whether control works.
        if (r.target_bitrate and r.achieved_bitrate
                and r.segment_count >= 5):
            # undershoot is fine (easy content hits the min-QP quality
            # cap below target); overshoot means control broke. Short
            # outputs tolerate more: one bounded calibration-probe batch
            # still dominates a 5-segment average, and washes out by ~10.
            cap = 2.0 if r.segment_count < 10 else 1.5
            if (r.codec_string or "").startswith("av01"):
                # a delegated AV1 encoder's own one-pass VBR, not this
                # control loop: gate only the runaway case
                cap = 2.5
            ratio = r.achieved_bitrate / r.target_bitrate
            if ratio > cap:
                raise VerificationError(
                    f"{r.name}: achieved {r.achieved_bitrate} bps is "
                    f"{ratio:.1f}x the {r.target_bitrate} bps target "
                    f"(cap {cap}x at {r.segment_count} segments)")
        if r.mean_psnr_y is not None and r.mean_psnr_y < 18.0:
            raise VerificationError(
                f"{r.name}: mean PSNR-Y {r.mean_psnr_y:.1f} dB below the "
                "18 dB floor — reconstruction is broken")


@dataclass
class ProcessResult:
    source: VideoInfo
    run: RunResult
    out_dir: Path
    original_path: str | None
    master_playlist: str
    dash_manifest: str
    qualities: list[dict] = field(default_factory=list)
    audio_renditions: list[dict] = field(default_factory=list)

    # filled by process_video from the plan: rung name -> paired AAC rate
    audio_bitrates: dict[str, int] = field(default_factory=dict)
    # wall seconds per step: probe, original, ladder (``backend.run``),
    # audio (extraction, encodes, master/DASH again; within it one
    # ``audio_{kbps}k`` entry per rendition or TS audio stream encoded),
    # verify, manifest
    step_s: dict[str, float] = field(default_factory=dict)

    def to_db_rows(self) -> list[dict]:
        """Rows for the video_qualities table."""
        return [
            {
                "quality": r.name,
                "width": r.width,
                "height": r.height,
                "codec_string": r.codec_string,
                "bitrate": r.achieved_bitrate,
                "audio_bitrate": self.audio_bitrates.get(r.name),
                "segment_count": r.segment_count,
                "bytes": r.bytes_written,
                "mean_psnr_y": (None if r.mean_psnr_y is None
                                else round(r.mean_psnr_y, 2)),
            }
            for r in self.run.rungs
        ]


def process_video(
    source_path: str | Path,
    out_dir: str | Path,
    *,
    backend: Backend | None = None,
    device: str | torch.device = "cuda",
    progress_cb: ProgressFn | None = None,
    keep_original: bool = True,
    resume: bool = True,
    rungs=None,
    audio: bool = True,
    write_manifest: bool = True,
    **plan_opts,
) -> ProcessResult:
    """Run the full pipeline for one video. Blocking and compute-heavy.

    ``backend=None`` takes ``select_backend(device=device)``: a
    ``TorchBackend`` on ``device`` (default ``"cuda"``; raises without
    CUDA). The AAC encoders run their MDCT on the backend's device.
    """
    step_s: dict[str, float] = {}
    clock = time.perf_counter
    source_path = Path(source_path)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # Step 1: probe
    t0 = clock()
    info = get_video_info(source_path)
    step_s["probe"] = clock() - t0

    # Step 2: original passthrough (a byte copy: the containers are
    # already progressive MP4/Y4M)
    t0 = clock()
    original = None
    if keep_original:
        dst = out_dir / f"original{source_path.suffix.lower()}"
        if not (resume and dst.exists()
                and dst.stat().st_size == source_path.stat().st_size):
            tmp = dst.with_suffix(dst.suffix + ".tmp")
            shutil.copyfile(source_path, tmp)
            tmp.rename(dst)
        original = str(dst)
    step_s["original"] = clock() - t0

    # Step 3: ladder (+ thumbnail + per-rung playlists + master/DASH)
    # device.fault failpoint: an armed chaos run injects a synthetic
    # CUDA-shaped device error here, on the compute thread, mid-job.
    from vlog_tpu_torch.parallel import faults

    faults.maybe_inject_device_fault()
    be = backend or select_backend(device=device)
    plan = be.plan(info, rungs, out_dir, **plan_opts)
    # under a slot lease the job's device work goes to the lease's device
    from vlog_tpu_torch.parallel.scheduler import device_for_run

    dev = device_for_run(be.device)
    if plan.streaming_format == "hls_ts" and audio and info.audio_codec:
        # Classic HLS muxes audio INTO each variant's TS; pre-encode one
        # ADTS stream per distinct ladder audio bitrate for the backend
        # to interleave.
        from vlog_tpu_torch.codecs.aac import AacEncoder
        from vlog_tpu_torch.codecs.aac.adts import split_adts_frames
        from vlog_tpu_torch.media.audio import extract_audio
        from vlog_tpu_torch.worker.audio import normalize_for_encode

        t0 = clock()
        src_audio = extract_audio(source_path)
        if src_audio is not None and src_audio.pcm.size:
            norm = normalize_for_encode(src_audio)
            plan.audio_adts = {}
            for rate in sorted({r.audio_bitrate for r in plan.rungs
                                if r.audio_bitrate}):
                t1 = clock()
                aenc = AacEncoder(sample_rate=norm.sample_rate, channels=2,
                                  bitrate=rate, device=dev)
                frames = split_adts_frames(aenc.encode_adts(norm.pcm))
                plan.audio_adts[rate] = (frames, norm.sample_rate)
                step_s[f"audio_{rate // 1000}k"] = clock() - t1
        step_s["audio"] = clock() - t0
    t0 = clock()
    run = be.run(plan, progress_cb, resume=resume)
    step_s["ladder"] = clock() - t0

    # Step 3b: audio rendition group (one per distinct ladder audio
    # bitrate), then re-emit master/DASH including the audio tracks.
    # (hls_ts mode muxed audio into the variants above instead.)
    audio_refs: list[hls.AudioRendition] = []
    if audio and info.audio_codec and plan.streaming_format != "hls_ts":
        from vlog_tpu_torch.media.audio import extract_audio
        from vlog_tpu_torch.worker.audio import encode_audio_renditions

        t0 = clock()
        src_audio = extract_audio(source_path)
        if src_audio is not None and src_audio.pcm.size:
            bitrates = [r.audio_bitrate for r in plan.rungs
                        if r.audio_bitrate]
            audio_refs = encode_audio_renditions(
                src_audio, out_dir, bitrates,
                segment_duration_s=plan.segment_duration_s, resume=resume,
                device=dev, stage_s=step_s)
            if audio_refs and run.variants:
                atomic_write_text(out_dir / "master.m3u8",
                    hls.master_playlist(run.variants, audio=audio_refs))
                atomic_write_text(out_dir / "manifest.mpd", hls.dash_manifest(
                    run.variants, duration_s=run.duration_s,
                    segment_duration_s=run.segment_duration_s,
                    audio=audio_refs))
        step_s["audio"] = clock() - t0

    # Step 4: verification
    t0 = clock()
    master = out_dir / "master.m3u8"
    verify_output(master, run, expect_cmaf=plan.streaming_format == "cmaf")
    step_s["verify"] = clock() - t0

    # Step 4b: integrity manifest, after verification so outputs.json
    # never blesses a tree the validators rejected. Remote workers pass
    # write_manifest=False: their uploader derives the manifest from the
    # digests it transferred.
    t0 = clock()
    if write_manifest:
        from vlog_tpu_torch.storage import integrity

        integrity.write_manifest(out_dir, integrity.build_manifest(out_dir))
    step_s["manifest"] = clock() - t0

    result = ProcessResult(
        source=info,
        run=run,
        out_dir=out_dir,
        original_path=original,
        master_playlist=str(master),
        dash_manifest=str(out_dir / "manifest.mpd"),
        audio_renditions=[
            {"name": a.name, "bitrate": a.bitrate, "channels": a.channels,
             "codecs": a.codecs, "uri": a.uri}
            for a in audio_refs
        ],
        audio_bitrates={r.name: r.audio_bitrate for r in plan.rungs
                        if r.audio_bitrate},
        step_s=step_s,
    )
    result.qualities = result.to_db_rows()
    return result
