"""HLS playlists (media + master, TS and CMAF variants), DASH MPD, validators.

Reference parity: transcoder.py:1264-1471 (generate_master_playlist{,_cmaf},
generate_dash_manifest) and transcoder.py:816-947 (validate_hls_playlist,
including the fMP4 `moof` atom check).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from pathlib import Path


@dataclass
class SegmentRef:
    uri: str
    duration_s: float


@dataclass
class VariantRef:
    """One rung as referenced by the master playlist."""

    name: str                 # "720p"
    uri: str                  # "720p/playlist.m3u8"
    bandwidth: int            # peak bits/sec (video+audio)
    width: int
    height: int
    codecs: str               # RFC 6381, e.g. "avc1.42C01F"
    frame_rate: float = 0.0
    audio_group: str = ""     # EXT-X-MEDIA GROUP-ID this rung pairs with


@dataclass
class AudioRendition:
    """One audio-only rendition (reference ladder pairs audio bitrates
    with rungs, README.md:201-212; CMAF carries them as a separate
    track group)."""

    name: str                 # "audio_128k"
    uri: str                  # "audio_128k/playlist.m3u8"
    group_id: str             # "aud128"
    bitrate: int
    channels: int = 2
    codecs: str = "mp4a.40.2"
    language: str = "und"
    default: bool = True
    sample_rate: int = 48000


# --------------------------------------------------------------------------
# Writers
# --------------------------------------------------------------------------

def media_playlist(
    segments: list[SegmentRef],
    *,
    target_duration_s: float,
    init_uri: str | None = None,
    version: int | None = None,
) -> str:
    """VOD media playlist; ``init_uri`` set => CMAF (EXT-X-MAP)."""
    ver = version if version is not None else (7 if init_uri else 3)
    lines = [
        "#EXTM3U",
        f"#EXT-X-VERSION:{ver}",
        f"#EXT-X-TARGETDURATION:{int(target_duration_s + 0.999)}",
        "#EXT-X-MEDIA-SEQUENCE:0",
        "#EXT-X-PLAYLIST-TYPE:VOD",
    ]
    if init_uri:
        lines.append(f'#EXT-X-MAP:URI="{init_uri}"')
    for seg in segments:
        lines.append(f"#EXTINF:{seg.duration_s:.5f},")
        lines.append(seg.uri)
    lines.append("#EXT-X-ENDLIST")
    return "\n".join(lines) + "\n"


def master_playlist(variants: list[VariantRef],
                    audio: list[AudioRendition] | None = None) -> str:
    lines = ["#EXTM3U", "#EXT-X-VERSION:7"]
    for a in audio or []:
        lines.append(
            "#EXT-X-MEDIA:TYPE=AUDIO,"
            f'GROUP-ID="{a.group_id}",NAME="{a.name}",'
            f'LANGUAGE="{a.language}",'
            f"DEFAULT={'YES' if a.default else 'NO'},AUTOSELECT=YES,"
            f"CHANNELS=\"{a.channels}\",URI=\"{a.uri}\""
        )
    for v in sorted(variants, key=lambda v: -v.bandwidth):
        codecs = v.codecs
        bandwidth = v.bandwidth
        paired = (next((a for a in audio if a.group_id == v.audio_group), None)
                  if v.audio_group and audio else None)
        if paired is not None:
            codecs = f"{codecs},{paired.codecs}"
            bandwidth += paired.bitrate
        attrs = [
            f"BANDWIDTH={bandwidth}",
            f"RESOLUTION={v.width}x{v.height}",
            f'CODECS="{codecs}"',
        ]
        if v.frame_rate:
            attrs.append(f"FRAME-RATE={v.frame_rate:.3f}")
        if paired is not None:   # never reference an undefined GROUP-ID
            attrs.append(f'AUDIO="{v.audio_group}"')
        lines.append("#EXT-X-STREAM-INF:" + ",".join(attrs))
        lines.append(v.uri)
    return "\n".join(lines) + "\n"


def dash_manifest(
    variants: list[VariantRef],
    *,
    duration_s: float,
    segment_duration_s: float,
    timescale: int = 90_000,
    audio: list[AudioRendition] | None = None,
) -> str:
    """Static MPD with SegmentTemplate per representation.

    Segment files must follow ``{name}/segment_$Number%05d$.m4s`` with
    ``{name}/init.mp4``, matching the CMAF layout written by the worker.
    """
    def iso_dur(s: float) -> str:
        return f"PT{s:.3f}S"

    reps = []
    for v in sorted(variants, key=lambda v: -v.bandwidth):
        base = v.uri.rsplit("/", 1)[0]  # "720p/playlist.m3u8" -> "720p"
        reps.append(
            f'      <Representation id="{v.name}" bandwidth="{v.bandwidth}" '
            f'width="{v.width}" height="{v.height}" codecs="{v.codecs}">\n'
            f'        <SegmentTemplate timescale="{timescale}" '
            f'duration="{int(segment_duration_s * timescale)}" '
            f'initialization="{base}/init.mp4" '
            f'media="{base}/segment_$Number%05d$.m4s" startNumber="1"/>\n'
            f"      </Representation>"
        )
    reps_xml = "\n".join(reps)
    audio_xml = ""
    if audio:
        areps = []
        for a in sorted(audio, key=lambda a: -a.bitrate):
            base = a.uri.rsplit("/", 1)[0]
            # Audio segments hold a whole number of 1024-sample AAC
            # frames; declare the EXACT duration in the audio timescale
            # or number-based addressing drifts over long videos.
            seg_samples = max(1, round(segment_duration_s * a.sample_rate
                                       / 1024)) * 1024
            areps.append(
                f'      <Representation id="{a.name}" bandwidth="{a.bitrate}" '
                f'audioSamplingRate="{a.sample_rate}" codecs="{a.codecs}">\n'
                f'        <SegmentTemplate timescale="{a.sample_rate}" '
                f'duration="{seg_samples}" '
                f'initialization="{base}/init.mp4" '
                f'media="{base}/segment_$Number%05d$.m4s" startNumber="1"/>\n'
                f"      </Representation>"
            )
        audio_xml = (
            '    <AdaptationSet mimeType="audio/mp4" segmentAlignment="true" '
            'startWithSAP="1">\n' + "\n".join(areps) + "\n    </AdaptationSet>\n"
        )
    return (
        '<?xml version="1.0" encoding="UTF-8"?>\n'
        '<MPD xmlns="urn:mpeg:dash:schema:mpd:2011" type="static" '
        f'mediaPresentationDuration="{iso_dur(duration_s)}" '
        f'minBufferTime="{iso_dur(segment_duration_s * 2)}" '
        'profiles="urn:mpeg:dash:profile:isoff-on-demand:2011">\n'
        f'  <Period duration="{iso_dur(duration_s)}">\n'
        '    <AdaptationSet mimeType="video/mp4" segmentAlignment="true" '
        'startWithSAP="1">\n'
        f"{reps_xml}\n"
        "    </AdaptationSet>\n"
        f"{audio_xml}"
        "  </Period>\n"
        "</MPD>\n"
    )


# --------------------------------------------------------------------------
# Validators (reference: validate_hls_playlist transcoder.py:816-947)
# --------------------------------------------------------------------------

class PlaylistValidationError(ValueError):
    pass


def _contains_top_level_box(data: bytes, fourcc: bytes) -> bool:
    pos = 0
    while pos + 8 <= len(data):
        size = struct.unpack(">I", data[pos : pos + 4])[0]
        if data[pos + 4 : pos + 8] == fourcc:
            return True
        if size == 1:
            if pos + 16 > len(data):
                return False
            size = struct.unpack(">Q", data[pos + 8 : pos + 16])[0]
        if size < 8:
            return False
        pos += size
    return False


def validate_media_playlist(path: str | Path, *, expect_cmaf: bool | None = None) -> dict:
    """Parse + cross-check a media playlist against on-disk segments.

    Checks (mirroring the reference's gauntlet):
    - playlist structure: header, ENDLIST, every EXTINF paired with a URI
    - every referenced segment exists and is non-empty
    - CMAF: init segment exists and contains ``moov``; every media segment
      contains a ``moof`` atom (transcoder.py:930-941 analog)
    Returns summary stats; raises PlaylistValidationError on any failure.
    """
    path = Path(path)
    if not path.exists():
        raise PlaylistValidationError(f"{path}: playlist missing")
    text = path.read_text()
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    if not lines or lines[0] != "#EXTM3U":
        raise PlaylistValidationError(f"{path}: missing #EXTM3U header")
    if "#EXT-X-ENDLIST" not in lines:
        raise PlaylistValidationError(f"{path}: missing #EXT-X-ENDLIST (truncated?)")

    init_uri = None
    for ln in lines:
        if ln.startswith("#EXT-X-MAP:"):
            if 'URI="' not in ln:
                raise PlaylistValidationError(f"{path}: EXT-X-MAP without quoted URI")
            init_uri = ln.split('URI="', 1)[1].split('"', 1)[0]
    is_cmaf = init_uri is not None
    if expect_cmaf is not None and is_cmaf != expect_cmaf:
        raise PlaylistValidationError(
            f"{path}: expected {'CMAF' if expect_cmaf else 'TS'} playlist"
        )

    segments: list[tuple[str, float]] = []
    pending_duration: float | None = None
    for ln in lines:
        if ln.startswith("#EXTINF:"):
            if pending_duration is not None:
                raise PlaylistValidationError(f"{path}: EXTINF without segment URI")
            pending_duration = float(ln[len("#EXTINF:"):].split(",", 1)[0])
        elif not ln.startswith("#"):
            if pending_duration is None:
                raise PlaylistValidationError(f"{path}: segment URI without EXTINF")
            segments.append((ln, pending_duration))
            pending_duration = None
    if pending_duration is not None:
        raise PlaylistValidationError(f"{path}: trailing EXTINF without URI")
    if not segments:
        raise PlaylistValidationError(f"{path}: no segments")

    base = path.parent
    if is_cmaf:
        init_path = base / init_uri
        if not init_path.exists() or init_path.stat().st_size == 0:
            raise PlaylistValidationError(f"{path}: init segment {init_uri} missing")
        if not _contains_top_level_box(init_path.read_bytes(), b"moov"):
            raise PlaylistValidationError(f"{path}: init segment has no moov box")
    total = 0.0
    for uri, dur in segments:
        seg_path = base / uri
        if not seg_path.exists() or seg_path.stat().st_size == 0:
            raise PlaylistValidationError(f"{path}: segment {uri} missing/empty")
        if is_cmaf:
            head = seg_path.read_bytes()
            if not _contains_top_level_box(head, b"moof"):
                raise PlaylistValidationError(f"{path}: segment {uri} has no moof atom")
        total += dur
    return {"segments": len(segments), "duration_s": total, "cmaf": is_cmaf}


def validate_master_playlist(path: str | Path) -> dict:
    """Validate master playlist + recursively validate each variant."""
    path = Path(path)
    if not path.exists():
        raise PlaylistValidationError(f"{path}: master playlist missing")
    lines = [ln.strip() for ln in path.read_text().splitlines() if ln.strip()]
    if not lines or lines[0] != "#EXTM3U":
        raise PlaylistValidationError(f"{path}: missing #EXTM3U header")
    variants = []
    media_uris = []
    expect_uri = False
    for ln in lines:
        if ln.startswith("#EXT-X-STREAM-INF:"):
            if expect_uri:
                raise PlaylistValidationError(f"{path}: STREAM-INF without URI")
            expect_uri = True
        elif ln.startswith("#EXT-X-MEDIA:") and 'URI="' in ln:
            media_uris.append(ln.split('URI="', 1)[1].split('"', 1)[0])
        elif not ln.startswith("#") and expect_uri:
            variants.append(ln)
            expect_uri = False
    if expect_uri:
        raise PlaylistValidationError(f"{path}: trailing STREAM-INF without URI")
    if not variants:
        raise PlaylistValidationError(f"{path}: no variants")
    results = {}
    for uri in variants + media_uris:
        results[uri] = validate_media_playlist(path.parent / uri)
    return results
