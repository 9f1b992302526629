"""H.264/AVC (port of ``vlog_tpu/codecs/h264``): the device DSP in
PyTorch (intra ``encoder``, inter ``inter``, in-loop ``deblock``), the
native CABAC/CAVLC entropy coders, the decoder, and ``api.H264Encoder``
(frames in, access units out). The syntax helpers are re-exported as
the reference's package does."""

from vlog_tpu_torch.codecs.h264.syntax import (  # noqa: F401
    NalUnit,
    make_sps,
    make_pps,
    annexb,
    avcc_config,
)
