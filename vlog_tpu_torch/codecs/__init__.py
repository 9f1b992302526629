"""Codecs of the port: the H.264 and HEVC device DSP with their host
entropy coders, the AAC encoder and decoder, the JPEG encoder.

The codec/container rulebook below is a copy of ``vlog_tpu/codecs``'s:
the port's worker shares its job queue with the JAX package's API
servers, so it validates a re-encode's payload by the same rules. AV1 is
in the rulebook but not ported (ROADMAP Queue A item 11): the backend
refuses it when it plans the run.
"""

# Codecs the product plane can encode to.
ENCODER_CODECS = ("h264", "h265", "av1")


def no_encoder_error(codec: str) -> str:
    return (f"codec {codec!r} has no encoder "
            f"(supported: {', '.join(ENCODER_CODECS)})")


def validate_codec_format(codec: str, streaming_format: str) -> str | None:
    """An error message, or None when the codec/container combination
    is encodable. h265/av1 are CMAF-only."""
    if codec not in ENCODER_CODECS:
        return no_encoder_error(codec)
    if codec in ("h265", "av1") and streaming_format != "cmaf":
        return f"{codec} output is CMAF-only"
    return None
