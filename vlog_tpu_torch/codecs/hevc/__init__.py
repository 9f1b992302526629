"""First-party HEVC (H.265) encoder on PyTorch (port of
``vlog_tpu/codecs/hevc``): the device DSP (core.py, deblock.py) and the
host CABAC entropy (native/hevc_cabac.c; the Python writers code the
two-part CUs and check the C coder). See syntax.py for the stream shape
and api.py for the encoder."""
