"""Storage integrity: streaming digests, the ``outputs.json`` tree
manifest (build / load / verify), disk admission, and the orphan GC
(``storage/gc.py``: stale temps, deleted and orphan trees, abandoned
worker workspaces) (port of ``vlog_tpu/storage``)."""

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
