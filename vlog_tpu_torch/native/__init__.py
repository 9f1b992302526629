"""Native (C) host entropy coder for the port: H.264 CABAC slices."""

from vlog_tpu_torch.native.build import NativeBuildError, get_lib  # noqa: F401
