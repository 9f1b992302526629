"""Native (C) host code for the port: the entropy coders (H.264 CABAC
and CAVLC slices, NAL emulation prevention, the JPEG scan packer) and the
optional libav ingest shim."""

from vlog_tpu_torch.native.build import (  # noqa: F401
    NativeBuildError,
    VtAvInfo,
    get_av_lib,
    get_lib,
)
