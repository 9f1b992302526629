"""ADTS framing (ISO/IEC 14496-3 1.A.3) + AudioSpecificConfig (copy of
``vlog_tpu/codecs/aac/adts.py``).

ADTS is the raw-AAC transport used for test vectors and .aac dumps; MP4
carries the same raw_data_blocks with an AudioSpecificConfig in esds.
"""

from __future__ import annotations

from dataclasses import dataclass

SAMPLE_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350)

AOT_AAC_LC = 2


def sample_rate_index(rate: int) -> int:
    try:
        return SAMPLE_RATES.index(rate)
    except ValueError:
        raise ValueError(f"unsupported AAC sample rate {rate}") from None


@dataclass(frozen=True)
class AacConfig:
    sample_rate: int
    channels: int            # 1 or 2
    object_type: int = AOT_AAC_LC

    @property
    def sr_index(self) -> int:
        return sample_rate_index(self.sample_rate)

    def audio_specific_config(self) -> bytes:
        """2-byte ASC: 5-bit AOT, 4-bit sr index, 4-bit channel config."""
        v = (self.object_type << 11) | (self.sr_index << 7) | (self.channels << 3)
        return bytes([(v >> 8) & 0xFF, v & 0xFF])

    @classmethod
    def from_audio_specific_config(cls, asc: bytes) -> "AacConfig":
        if len(asc) < 2:
            raise ValueError("AudioSpecificConfig too short")
        v = (asc[0] << 8) | asc[1]
        aot = v >> 11
        sr_idx = (v >> 7) & 0xF
        ch = (v >> 3) & 0xF
        if sr_idx == 0xF:
            raise ValueError("explicit sample rate ASC not supported")
        return cls(sample_rate=SAMPLE_RATES[sr_idx], channels=ch,
                   object_type=aot)


def adts_header(config: AacConfig, frame_len: int) -> bytes:
    """7-byte ADTS header (no CRC) for one raw_data_block of frame_len
    payload bytes."""
    full = frame_len + 7
    profile = config.object_type - 1          # ADTS profile = AOT - 1
    h = bytearray(7)
    h[0] = 0xFF
    h[1] = 0xF1                               # MPEG-4, no CRC
    h[2] = (profile << 6) | (config.sr_index << 2) | ((config.channels >> 2) & 1)
    h[3] = ((config.channels & 3) << 6) | ((full >> 11) & 0x3)
    h[4] = (full >> 3) & 0xFF
    h[5] = ((full & 0x7) << 5) | 0x1F
    h[6] = 0xFC
    return bytes(h)


def split_adts_frames(data: bytes) -> list[bytes]:
    """ADTS stream -> whole frames WITH headers (what TS carriage needs:
    stream_type 0x0F is ADTS-framed AAC, ISO 13818-7)."""
    frames = []
    i = 0
    n = len(data)
    while i + 7 <= n:
        if data[i] != 0xFF or (data[i + 1] & 0xF0) != 0xF0:
            raise ValueError(f"bad ADTS syncword at {i}")
        full = ((data[i + 3] & 0x3) << 11) | (data[i + 4] << 3) \
            | (data[i + 5] >> 5)
        if full < 7 or i + full > n:
            raise ValueError("truncated ADTS frame")
        frames.append(data[i:i + full])
        i += full
    return frames


def split_adts(data: bytes) -> tuple[AacConfig, list[bytes]]:
    """ADTS stream -> (config, [raw_data_block payloads])."""
    frames = []
    cfg = None
    i = 0
    n = len(data)
    while i + 7 <= n:
        if data[i] != 0xFF or (data[i + 1] & 0xF0) != 0xF0:
            raise ValueError(f"bad ADTS syncword at {i}")
        crc_absent = data[i + 1] & 1
        profile = (data[i + 2] >> 6) + 1
        sr_idx = (data[i + 2] >> 2) & 0xF
        ch = ((data[i + 2] & 1) << 2) | (data[i + 3] >> 6)
        full = ((data[i + 3] & 0x3) << 11) | (data[i + 4] << 3) | (data[i + 5] >> 5)
        if full < 7 or i + full > n:
            raise ValueError("truncated ADTS frame")
        hdr = 7 if crc_absent else 9
        if cfg is None:
            cfg = AacConfig(sample_rate=SAMPLE_RATES[sr_idx], channels=ch,
                            object_type=profile)
        frames.append(data[i + hdr:i + full])
        i += full
    if cfg is None:
        raise ValueError("no ADTS frames found")
    return cfg, frames
