"""Native (C) host entropy coders for the port: H.264 CABAC and CAVLC
slices, NAL emulation prevention, the JPEG scan packer."""

from vlog_tpu_torch.native.build import NativeBuildError, get_lib  # noqa: F401
