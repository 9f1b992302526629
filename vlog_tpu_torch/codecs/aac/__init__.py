"""First-party AAC-LC codec: the encoder with its MDCT on the device, and
the host decoder (port of ``vlog_tpu/codecs/aac``)."""

from vlog_tpu_torch.codecs.aac.adts import AacConfig, adts_header, split_adts
from vlog_tpu_torch.codecs.aac.decoder import AacDecoder, decode_adts
from vlog_tpu_torch.codecs.aac.encoder import AacEncoder

__all__ = [
    "AacConfig",
    "AacDecoder",
    "AacEncoder",
    "adts_header",
    "decode_adts",
    "split_adts",
]
