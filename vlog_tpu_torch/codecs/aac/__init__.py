"""The host AAC-LC decoder (copies of ``vlog_tpu/codecs/aac``'s ADTS
framing, tables, Huffman books and decoder; the device MDCT encoder is
not ported yet)."""

from vlog_tpu_torch.codecs.aac.adts import AacConfig, split_adts
from vlog_tpu_torch.codecs.aac.decoder import AacDecoder, decode_adts

__all__ = ["AacConfig", "AacDecoder", "decode_adts", "split_adts"]
