"""Small shared utilities."""

from vlog_tpu_torch.utils.fsio import atomic_write_bytes, atomic_write_text  # noqa: F401
