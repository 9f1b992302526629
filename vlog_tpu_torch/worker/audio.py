"""Audio rendition stage: source audio -> AAC CMAF rendition group (port
of ``vlog_tpu/worker/audio.py``; the encoders' MDCT runs on ``device``).

One rendition per distinct ladder audio bitrate, referenced from the
master playlist (EXT-X-MEDIA):

    {out}/audio_{kbps}k/init.mp4
    {out}/audio_{kbps}k/segment_%05d.m4s
    {out}/audio_{kbps}k/playlist.m3u8
"""

from __future__ import annotations

import time
from pathlib import Path

import torch

from vlog_tpu_torch.codecs.aac import AacEncoder
from vlog_tpu_torch.device import resolve_device
from vlog_tpu_torch.media import hls
from vlog_tpu_torch.media.audio import AudioData, resample, to_stereo
from vlog_tpu_torch.utils.fsio import atomic_write_bytes, atomic_write_text
from vlog_tpu_torch.media.fmp4 import (
    Sample,
    TrackConfig,
    init_segment,
    media_segment,
    mp4a_sample_entry,
)

FRAME_SAMPLES = 1024
SUPPORTED_RATES = (48000, 44100, 32000, 24000, 22050, 16000)


def normalize_for_encode(audio: AudioData) -> AudioData:
    """Stereo + a rate the AAC tables support (prefer keeping the source
    rate; resample to 48 kHz otherwise)."""
    audio = to_stereo(audio)
    if audio.sample_rate not in SUPPORTED_RATES:
        audio = resample(audio, 48000)
    return audio


def encode_audio_renditions(
    audio: AudioData,
    out_dir: str | Path,
    bitrates: list[int],
    *,
    segment_duration_s: float = 6.0,
    resume: bool = True,
    device: str | torch.device = "cuda",
    stage_s: dict | None = None,
) -> list[hls.AudioRendition]:
    """Encode one rendition per distinct bitrate (the MDCT on ``device``;
    raises without CUDA on the default); returns their refs. Each
    rendition encoded adds its wall seconds to ``stage_s[name]``."""
    device = resolve_device(device)
    out_dir = Path(out_dir)
    audio = normalize_for_encode(audio)
    sr = audio.sample_rate
    frames_per_seg = max(1, round(segment_duration_s * sr / FRAME_SAMPLES))
    renditions: list[hls.AudioRendition] = []
    # Dedupe by the kbps bucket that names the rendition directory and
    # GROUP-ID — two rates in one bucket would collide on disk.
    buckets = sorted({b // 1000 for b in bitrates if b > 0}, reverse=True)
    for kbps in buckets:
        bps = kbps * 1000
        name = f"audio_{kbps}k"
        rdir = out_dir / name
        ref = hls.AudioRendition(
            name=name, uri=f"{name}/playlist.m3u8",
            group_id=f"aud{kbps}", bitrate=bps, channels=2, sample_rate=sr,
        )
        playlist = rdir / "playlist.m3u8"
        if resume and playlist.exists():
            try:
                hls.validate_media_playlist(playlist, expect_cmaf=True)
                renditions.append(ref)
                continue                      # rendition already complete
            except hls.PlaylistValidationError:
                pass
        t0 = time.perf_counter()
        rdir.mkdir(parents=True, exist_ok=True)
        enc = AacEncoder(sample_rate=sr, channels=2, bitrate=bps,
                         device=device)
        track = TrackConfig(
            track_id=1, handler="soun", timescale=sr,
            sample_entry=mp4a_sample_entry(
                2, sr, enc.config.audio_specific_config(), avg_bitrate=bps),
        )
        atomic_write_bytes(rdir / "init.mp4", init_segment(track))
        # Drop the priming frame: the timeline then starts at t=0 with a
        # ~21ms windowed fade-in instead of a 1024-sample lead.
        payloads = enc.encode_frames(audio.pcm)[1:]
        seg_refs: list[hls.SegmentRef] = []
        idx = 0
        base_time = 0
        for s in range(0, len(payloads), frames_per_seg):
            chunk = payloads[s:s + frames_per_seg]
            samples = [Sample(data=p, duration=FRAME_SAMPLES, is_sync=True)
                       for p in chunk]
            data = media_segment(track, idx + 1, base_time, samples)
            path = rdir / f"segment_{idx + 1:05d}.m4s"
            tmp = path.with_suffix(".m4s.tmp")
            tmp.write_bytes(data)
            tmp.rename(path)
            dur = len(chunk) * FRAME_SAMPLES
            seg_refs.append(hls.SegmentRef(
                uri=path.name, duration_s=dur / sr))
            base_time += dur
            idx += 1
        atomic_write_text(playlist, hls.media_playlist(
            seg_refs, target_duration_s=segment_duration_s,
            init_uri="init.mp4"))
        if stage_s is not None:
            stage_s[name] = time.perf_counter() - t0
        renditions.append(ref)
    return renditions
