"""End-to-end artifact integrity: digests, tree manifests, disk admission
(copy of ``vlog_tpu/storage/integrity.py``; the manifest format is
shared, so either package verifies a tree the other wrote).

- **Streaming digests** (:func:`sha256_file`), with a (size, mtime_ns)
  validated cache for inventory listings (:func:`sha256_file_cached`).
- **Tree manifest** (``outputs.json``): ``rel -> {size, sha256}`` over a
  video's output tree, written last (after every file it describes) and
  deterministic, so identical trees give byte-identical manifests.
- **Disk admission** (:func:`under_pressure`): the
  ``VLOG_MIN_FREE_DISK_GB`` floor (config.MIN_FREE_DISK_BYTES), read at
  call time.

All functions are synchronous and blocking (they read whole files).
"""

from __future__ import annotations

import hashlib
import json
import shutil
import threading
from pathlib import Path

from vlog_tpu_torch import config
from vlog_tpu_torch.backends.rc_journal import RC_JOURNAL_NAME
from vlog_tpu_torch.utils import failpoints
from vlog_tpu_torch.utils.fsio import atomic_write_text

MANIFEST_NAME = "outputs.json"
MANIFEST_VERSION = 1

_CHUNK = 1 << 20

# File name suffixes that are never published artifacts (in-flight temps).
TEMP_SUFFIXES = (".part", ".tmp")
# Admin-upload staging prefix (api/admin_api.py upload_video).
UPLOAD_TEMP_PREFIX = ".upload-"


class ManifestError(ValueError):
    """A stored manifest is unreadable or structurally invalid."""


def sha256_file(path: str | Path, *, chunk_size: int = _CHUNK) -> str:
    """Streaming SHA-256 of a file (constant memory)."""
    h = hashlib.sha256()
    with open(path, "rb") as fp:
        while True:
            block = fp.read(chunk_size)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


# (size, mtime_ns)-validated digest cache, seeded by the upload handler
# with the digest it already computed in the request path — so the
# resume inventory is stat-only in steady state instead of re-hashing a
# multi-GB tree per call. verify_tree deliberately does NOT use it: its
# whole purpose is re-reading the bytes to catch rot the stat can't see.
_DIGEST_CACHE_MAX = 65536
_digest_cache: dict[str, tuple[int, int, str]] = {}
_digest_cache_lock = threading.Lock()


def _cache_key(p: Path) -> str:
    return str(p)


def note_digest(path: str | Path, digest: str) -> None:
    """Record a just-verified digest for ``path`` (upload handler)."""
    p = Path(path)
    try:
        st = p.stat()
    except OSError:
        return
    with _digest_cache_lock:
        if len(_digest_cache) >= _DIGEST_CACHE_MAX:
            _digest_cache.clear()     # coarse but bounded; cache re-warms
        _digest_cache[_cache_key(p)] = (st.st_size, st.st_mtime_ns, digest)


def sha256_file_cached(path: str | Path) -> str:
    """sha256_file with (size, mtime_ns) cache validation — for
    inventory listings, NOT for integrity verification."""
    p = Path(path)
    st = p.stat()
    key = _cache_key(p)
    with _digest_cache_lock:
        hit = _digest_cache.get(key)
    if hit is not None and hit[0] == st.st_size \
            and hit[1] == st.st_mtime_ns:
        return hit[2]
    digest = sha256_file(p)
    with _digest_cache_lock:
        if len(_digest_cache) >= _DIGEST_CACHE_MAX:
            _digest_cache.clear()
        _digest_cache[key] = (st.st_size, st.st_mtime_ns, digest)
    return digest


def _is_temp(name: str) -> bool:
    return name.endswith(TEMP_SUFFIXES) or name.startswith(UPLOAD_TEMP_PREFIX)


def build_manifest(root: str | Path, *,
                   skip_prefixes: tuple[str, ...] = (),
                   use_cache: bool = False) -> dict[str, dict]:
    """``rel -> {size, sha256}`` over every published file under ``root``.

    Temps (``.part`` / ``.tmp`` / ``.upload-*``) and the manifest itself
    are excluded — the manifest describes the publishable tree only.
    ``use_cache`` is for inventory listings (upload_status): digests the
    upload path already verified are reused via the (size, mtime) cache
    instead of re-hashing the tree. Manifests that *gate* publication
    keep the default full hash.
    """
    root = Path(root)
    files: dict[str, dict] = {}
    if not root.exists():
        return files
    digest = sha256_file_cached if use_cache else sha256_file
    for p in sorted(root.rglob("*")):
        if not p.is_file() or _is_temp(p.name):
            continue
        rel = p.relative_to(root).as_posix()
        if rel == MANIFEST_NAME or rel == RC_JOURNAL_NAME:
            continue
        if any(rel.startswith(pre) for pre in skip_prefixes):
            continue
        files[rel] = {"size": p.stat().st_size, "sha256": digest(p)}
    return files


def write_manifest(root: str | Path, files: dict[str, dict]) -> Path:
    """Atomically publish ``outputs.json`` under ``root``; returns its path.

    Deliberately deterministic (no timestamp): identical trees must
    yield byte-identical manifests, preserving the bit-exactness
    invariant the mesh-equivalence suite holds process_video to.
    """
    root = Path(root)
    path = root / MANIFEST_NAME
    atomic_write_text(path, json.dumps(
        {"version": MANIFEST_VERSION, "files": files},
        indent=1, sort_keys=True))
    return path


def _rel_is_safe(rel: str) -> bool:
    """Manifest keys are worker-controlled: reject anything that could
    escape the tree (the upload path got _safe_relpath; the manifest
    CONTENT must get the same treatment before it touches the fs)."""
    if not rel or len(rel) > 512:
        return False
    p = Path(rel)
    if p.is_absolute():
        return False
    return not any(part in ("..", "") for part in p.parts)


def load_manifest(root: str | Path) -> dict[str, dict] | None:
    """The ``files`` mapping of a stored manifest, or None when the tree
    has no manifest (pre-integrity-plane uploads). A *present but
    unreadable or malformed* manifest raises :class:`ManifestError` —
    that is a verification failure, not an absence."""
    path = Path(root) / MANIFEST_NAME
    try:
        raw = path.read_text()
    except FileNotFoundError:
        return None
    except OSError as exc:
        raise ManifestError(f"manifest unreadable: {exc}") from exc
    try:
        doc = json.loads(raw)
        files = doc["files"]
        if not isinstance(files, dict):
            raise TypeError("files is not a mapping")
        for rel, entry in files.items():
            if not isinstance(entry, dict) \
                    or not isinstance(entry.get("size"), int) \
                    or not isinstance(entry.get("sha256"), str):
                raise TypeError(f"bad entry for {rel!r}")
    except (ValueError, KeyError, TypeError) as exc:
        raise ManifestError(f"manifest malformed: {exc}") from exc
    return files


def verify_tree(root: str | Path, files: dict[str, dict],
                *, check_digests: bool = True,
                use_cache: bool = False) -> list[str]:
    """Verify ``root`` against a manifest; returns problems (empty = ok).

    Every entry must exist with the recorded size and (when
    ``check_digests``) the recorded SHA-256 — existence and size gate
    first, so a truncated tree reports cheaply without hashing.
    ``use_cache`` trusts the (size, mtime)-validated digests the upload
    path already verified — the completion gate uses it so a 100 GB
    ladder isn't sequentially re-read inside the claim lease (upload
    already hashed every received byte; any post-upload rewrite bumps
    mtime and forces a real re-hash). On-demand rot auditing (the admin
    verify endpoint) keeps the default full re-read.
    The ``storage.verify`` failpoint forces a verification failure here
    so chaos runs can prove rejection paths end to end.
    """
    try:
        failpoints.hit("storage.verify")
    except failpoints.FailpointError as exc:
        return [str(exc)]
    root = Path(root)
    problems: list[str] = []
    for rel in sorted(files):
        want = files[rel]
        if not _rel_is_safe(rel):
            # a traversal/absolute key would escape root below — never
            # touch the filesystem with it, just fail the tree
            problems.append(f"{rel!r}: illegal path in manifest")
            continue
        p = root / rel
        if not p.is_file():
            problems.append(f"{rel}: missing")
            continue
        size = p.stat().st_size
        if size != want.get("size"):
            problems.append(
                f"{rel}: size {size} != manifest {want.get('size')}")
            continue
        if check_digests:
            got = sha256_file_cached(p) if use_cache else sha256_file(p)
            if got != want.get("sha256"):
                problems.append(
                    f"{rel}: sha256 {got[:12]}… != manifest "
                    f"{str(want.get('sha256'))[:12]}…")
    return problems


def manifest_digests(root: str | Path
                     ) -> tuple[int | None, dict[str, tuple[int, str]]]:
    """``(manifest mtime_ns, {rel: (size, sha256)})`` for a tree.

    The delivery plane seeds segment ETags from this so revalidation
    compares the real published digest, not an mtime proxy. Returns
    ``(None, {})`` when the tree has no (readable, well-formed) manifest
    — absence just downgrades ETags, it must never fail a serve. The
    mtime_ns is the staleness guard: ``outputs.json`` is rewritten by
    every publish/regenerate, so a changed mtime invalidates the map.
    """
    path = Path(root) / MANIFEST_NAME
    try:
        mtime_ns = path.stat().st_mtime_ns
        files = load_manifest(root)
    except (OSError, ManifestError):
        return None, {}
    if files is None:
        return None, {}
    return mtime_ns, {rel: (entry["size"], entry["sha256"])
                      for rel, entry in files.items()}


# --------------------------------------------------------------------------
# Disk admission control
# --------------------------------------------------------------------------

def free_bytes(path: str | Path) -> int:
    """Free bytes on the filesystem holding ``path`` (nearest existing
    ancestor when the path itself does not exist yet)."""
    p = Path(path)
    while not p.exists():
        parent = p.parent
        if parent == p:
            break
        p = parent
    try:
        return shutil.disk_usage(p).free
    except OSError:
        # An unstatable volume is treated as full: admitting writes to a
        # filesystem we cannot even measure is the riskier default.
        return 0


def under_pressure(path: str | Path, *, min_free: int | None = None) -> bool:
    """True when ``path``'s filesystem is below the admission floor.

    ``min_free`` defaults to ``config.MIN_FREE_DISK_BYTES`` read at call
    time (VLOG_MIN_FREE_DISK_GB; 0 disables admission control).
    """
    floor = config.MIN_FREE_DISK_BYTES if min_free is None else min_free
    if floor <= 0:
        return False
    return free_bytes(path) < floor
