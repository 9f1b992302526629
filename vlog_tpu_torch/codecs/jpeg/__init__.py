"""Baseline JFIF JPEG encoder (thumbnails): the DCT + quantization run on
the planes' device, Huffman coding on the host (native C)."""

from vlog_tpu_torch.codecs.jpeg.encoder import encode_jpeg_rgb, encode_jpeg_yuv420  # noqa: F401
