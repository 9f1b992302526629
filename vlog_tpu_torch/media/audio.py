"""Audio ingest: WAV IO, MP4 and ADTS audio through the host AAC
decoder, resampling, downmix and upmix (copy of
``vlog_tpu/media/audio.py``).

Host-side numpy: the MP4 demuxer hands over the AAC track, the decoder
produces PCM, and a polyphase resampler (scipy) feeds the transcription
front end and the AAC encoder. Foreign containers go through the
optional libav shim.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np


class AudioError(ValueError):
    pass


@dataclass
class AudioData:
    """Interleaved-decoded PCM: (channels, n_samples) float64 in [-1, 1)."""

    pcm: np.ndarray
    sample_rate: int

    @property
    def channels(self) -> int:
        return int(self.pcm.shape[0])

    @property
    def duration_s(self) -> float:
        return self.pcm.shape[1] / self.sample_rate if self.sample_rate else 0.0


# --------------------------------------------------------------------------
# WAV (RIFF PCM)
# --------------------------------------------------------------------------

def read_wav(path: str | Path) -> AudioData:
    data = Path(path).read_bytes()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    pcm = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise AudioError(f"{path}: missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 1 and bits == 16:
        x = np.frombuffer(pcm, "<i2").astype(np.float64) / 32768.0
    elif audio_format == 1 and bits == 8:
        x = (np.frombuffer(pcm, np.uint8).astype(np.float64) - 128.0) / 128.0
    elif audio_format == 3 and bits == 32:
        x = np.frombuffer(pcm, "<f4").astype(np.float64)
    else:
        raise AudioError(f"{path}: unsupported WAV format {audio_format}/{bits}bit")
    n = (x.shape[0] // channels) * channels
    return AudioData(pcm=x[:n].reshape(-1, channels).T.copy(),
                     sample_rate=rate)


def write_wav(path: str | Path, audio: AudioData) -> None:
    x = np.clip(audio.pcm, -1.0, 32767.0 / 32768.0)
    s16 = np.round(x.T * 32768.0).astype("<i2").tobytes()
    ch, rate = audio.channels, audio.sample_rate
    hdr = (b"RIFF" + struct.pack("<I", 36 + len(s16)) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, rate,
                                   rate * ch * 2, ch * 2, 16)
           + b"data" + struct.pack("<I", len(s16)))
    Path(path).write_bytes(hdr + s16)


# --------------------------------------------------------------------------
# MP4 audio track -> PCM
# --------------------------------------------------------------------------

def extract_mp4_audio(path: str | Path) -> AudioData | None:
    """Decode the first audio track of an MP4 (AAC or PCM); None if absent."""
    from vlog_tpu_torch.media.mp4 import SampleReader, parse_mp4

    movie = parse_mp4(path)
    track = movie.audio
    if track is None:
        return None
    if track.codec == "aac":
        from vlog_tpu_torch.codecs.aac.adts import AacConfig
        from vlog_tpu_torch.codecs.aac.decoder import AacDecoder

        asc = track.codec_config
        cfg = _asc_from_esds(asc)
        if cfg is None:
            cfg = AacConfig(sample_rate=track.sample_rate or 48000,
                            channels=track.channels or 2)
        dec = AacDecoder(cfg)
        chunks = []
        with SampleReader(path, track) as rd:
            for i in range(track.samples.count):
                chunks.append(dec.decode_frame(rd.read_sample(i)))
        if not chunks:
            return None
        pcm = np.concatenate(chunks, axis=1)
        # strip the 1024-sample codec priming delay
        return AudioData(pcm=pcm[:, 1024:], sample_rate=cfg.sample_rate)
    if track.codec == "pcm":
        with SampleReader(path, track) as rd:
            raw = b"".join(rd.read_sample(i)
                           for i in range(track.samples.count))
        ch = track.channels or 1
        x = np.frombuffer(raw, ">i2" if track.sample_entry_type == "twos"
                          else "<i2").astype(np.float64) / 32768.0
        n = (x.shape[0] // ch) * ch
        return AudioData(pcm=x[:n].reshape(-1, ch).T.copy(),
                         sample_rate=track.sample_rate or 48000)
    raise AudioError(f"{path}: unsupported audio codec {track.codec!r}")


def _asc_from_esds(esds_payload: bytes):
    """Pull the AudioSpecificConfig (tag 0x05 descriptor) out of an esds
    box payload; None if malformed."""
    from vlog_tpu_torch.codecs.aac.adts import AacConfig

    data = esds_payload[4:] if len(esds_payload) > 4 else b""  # skip ver/flags

    def walk(buf: bytes):
        pos = 0
        while pos + 2 <= len(buf):
            tag = buf[pos]
            pos += 1
            size = 0
            for _ in range(4):
                b = buf[pos]
                pos += 1
                size = (size << 7) | (b & 0x7F)
                if not b & 0x80:
                    break
            body = buf[pos:pos + size]
            if tag == 0x05:
                return body
            if tag == 0x03:
                # ES_Descriptor: ES_ID(2) + flags(1) [+ extensions we skip]
                found = walk(body[3:])
                if found:
                    return found
            elif tag == 0x04:
                found = walk(body[13:])
                if found:
                    return found
            pos += size
        return None

    asc = walk(data)
    if not asc or len(asc) < 2:
        return None
    try:
        return AacConfig.from_audio_specific_config(asc)
    except ValueError:
        return None


def _libav_extract_audio(path: Path) -> AudioData | None:
    """Foreign-container audio through the libav ingest shim (the
    reference decoded audio with ffmpeg; transcription.py:259-299)."""
    import tempfile

    from vlog_tpu_torch.native import get_av_lib

    lib = get_av_lib()
    if lib is None:
        return None
    with tempfile.NamedTemporaryFile(suffix=".f32", delete=False) as tmp:
        out_path = tmp.name
    try:
        rc = lib.vt_av_audio_to_f32(str(path).encode(), out_path.encode())
        if rc < 0:
            return None
        rate, channels = int(rc >> 8), int(rc & 0xFF)
        pcm = np.fromfile(out_path, np.float32)
        if channels > 1:
            pcm = pcm.reshape(-1, channels).T
        else:
            pcm = pcm[None, :]
        return AudioData(pcm=pcm.astype(np.float64), sample_rate=rate)
    finally:
        Path(out_path).unlink(missing_ok=True)


def extract_audio(path: str | Path) -> AudioData | None:
    """Best-effort audio from any supported source; None if the container
    has no audio (e.g. Y4M). First-party paths first; the libav shim
    covers foreign containers and codecs."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".wav":
        return read_wav(path)
    if suffix in (".aac", ".adts"):
        from vlog_tpu_torch.codecs.aac.decoder import decode_adts

        cfg, pcm = decode_adts(path.read_bytes())
        return AudioData(pcm=pcm[:, 1024:], sample_rate=cfg.sample_rate)
    from vlog_tpu_torch.media.probe import ProbeError, sniff_container

    try:
        kind = sniff_container(path)
    except ProbeError:
        return _libav_extract_audio(path)
    if kind == "mp4":
        try:
            audio = extract_mp4_audio(path)
        except Exception as exc:  # noqa: BLE001 — exotic MP4 audio -> shim
            from vlog_tpu_torch.native import get_av_lib

            if get_av_lib() is None:
                raise       # no fallback: surface the real error
            import logging

            logging.getLogger("vlog_tpu_torch.media").warning(
                "first-party MP4 audio demux failed (%s); using libav "
                "fallback", exc)
            audio = None
        if audio is not None:
            return audio
        return _libav_extract_audio(path)
    if kind != "y4m":
        return _libav_extract_audio(path)
    return None


# --------------------------------------------------------------------------
# Resampling / downmix
# --------------------------------------------------------------------------

def resample(audio: AudioData, rate: int) -> AudioData:
    if audio.sample_rate == rate:
        return audio
    from fractions import Fraction

    from scipy.signal import resample_poly

    frac = Fraction(rate, audio.sample_rate).limit_denominator(1 << 16)
    pcm = resample_poly(audio.pcm, frac.numerator, frac.denominator, axis=1)
    return AudioData(pcm=pcm, sample_rate=rate)


def to_mono(audio: AudioData) -> AudioData:
    if audio.channels == 1:
        return audio
    return AudioData(pcm=audio.pcm.mean(axis=0, keepdims=True),
                     sample_rate=audio.sample_rate)



def to_stereo(audio: AudioData) -> AudioData:
    if audio.channels == 2:
        return audio
    if audio.channels == 1:
        return AudioData(pcm=np.repeat(audio.pcm, 2, axis=0),
                         sample_rate=audio.sample_rate)
    return AudioData(pcm=audio.pcm[:2], sample_rate=audio.sample_rate)
