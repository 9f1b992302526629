"""Storage integrity: streaming digests, the ``outputs.json`` tree
manifest (build / load / verify) and disk admission (port of
``vlog_tpu/storage``; the orphan GC is not ported)."""

from vlog_tpu_torch.storage.integrity import (  # noqa: F401
    MANIFEST_NAME,
    ManifestError,
    build_manifest,
    free_bytes,
    load_manifest,
    sha256_file,
    under_pressure,
    verify_tree,
    write_manifest,
)
