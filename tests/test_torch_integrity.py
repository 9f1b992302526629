"""The port's storage integrity module (``vlog_tpu_torch/storage``) against
``vlog_tpu/storage/integrity.py`` on the same trees: manifests (the
rate-control journal and the ``.part``/``.tmp``/``.upload-`` temporaries
excluded) and ``outputs.json`` byte-identical, ``verify_tree`` findings
equal (a size change, a digest change, a missing file, an illegal key,
the ``storage.verify`` failpoint), ``load_manifest`` errors, the digest
cache, ``manifest_digests``, and disk admission.
"""

from __future__ import annotations

import json
import os

import pytest

from vlog_tpu.storage import integrity as jint
from vlog_tpu.utils import failpoints as jfp
from vlog_tpu_torch import config as tconfig
from vlog_tpu_torch.storage import integrity as tint
from vlog_tpu_torch.utils import failpoints as tfp


@pytest.fixture
def tree(tmp_path):
    """A small output tree with the files a run leaves beside the
    published ones."""
    root = tmp_path / "tree"
    files = {
        "master.m3u8": b"#EXTM3U\n",
        "360p/init.mp4": b"\x00" * 40,
        "360p/segment_00001.m4s": os.urandom(3000),
        "audio_96k/segment_00001.m4s": os.urandom(500),
        "thumbnail.jpg": b"\xff\xd8\xff\xd9",
        "rc_journal.jsonl": b'{"v":1}\n',
        "360p/segment_00002.m4s.tmp": b"partial",
        "upload.part": b"partial",
        ".upload-abc": b"staging",
    }
    for rel, data in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)
    return root


def test_manifest_equals_jax_and_excludes_run_state(tree):
    got, want = tint.build_manifest(tree), jint.build_manifest(tree)
    assert got == want
    assert set(got) == {"master.m3u8", "360p/init.mp4",
                        "360p/segment_00001.m4s",
                        "audio_96k/segment_00001.m4s", "thumbnail.jpg"}
    assert tint.RC_JOURNAL_NAME == jint.RC_JOURNAL_NAME
    assert tint.build_manifest(tree, skip_prefixes=("audio_",)) == \
        jint.build_manifest(tree, skip_prefixes=("audio_",))
    tint.write_manifest(tree, got)
    data = (tree / "outputs.json").read_bytes()
    jint.write_manifest(tree, want)
    assert (tree / "outputs.json").read_bytes() == data
    # the manifest never describes itself
    assert tint.build_manifest(tree) == got
    assert tint.load_manifest(tree) == jint.load_manifest(tree) == got


def test_verify_tree_flags_size_and_digest_changes(tree):
    files = tint.build_manifest(tree)
    assert tint.verify_tree(tree, files) == []
    seg = tree / "360p" / "segment_00001.m4s"
    data = bytearray(seg.read_bytes())
    data[100] ^= 0xFF                                # same size, new digest
    seg.write_bytes(bytes(data))
    (tree / "thumbnail.jpg").write_bytes(b"\xff\xd8\xff")     # shorter
    (tree / "master.m3u8").unlink()
    bad = dict(files, **{"../escape": {"size": 1, "sha256": "0" * 64}})
    got = tint.verify_tree(tree, bad)
    assert got == jint.verify_tree(tree, bad)
    assert len(got) == 4
    assert any(p.startswith("360p/segment_00001.m4s: sha256") for p in got)
    assert any(p.startswith("thumbnail.jpg: size 3 != manifest 4")
               for p in got)
    assert "master.m3u8: missing" in got
    assert "'../escape': illegal path in manifest" in got
    # without digests only the size and existence gates run
    assert tint.verify_tree(tree, files, check_digests=False) == \
        jint.verify_tree(tree, files, check_digests=False)


def test_storage_verify_failpoint(tree):
    files = tint.build_manifest(tree)
    tfp.arm("storage.verify", count=1)
    jfp.arm("storage.verify", count=1)
    try:
        assert tint.verify_tree(tree, files) == \
            jint.verify_tree(tree, files) == \
            ["failpoint 'storage.verify' triggered"]
        assert tint.verify_tree(tree, files) == []
    finally:
        tfp.reset()
        jfp.reset()


@pytest.mark.parametrize("doc", [
    "{not json", json.dumps({"version": 1}), json.dumps({"files": []}),
    json.dumps({"files": {"a": {"size": "1", "sha256": "x"}}}),
])
def test_load_manifest_malformed(tmp_path, doc):
    (tmp_path / "outputs.json").write_text(doc)
    with pytest.raises(tint.ManifestError) as got:
        tint.load_manifest(tmp_path)
    with pytest.raises(jint.ManifestError) as want:
        jint.load_manifest(tmp_path)
    assert str(got.value) == str(want.value)
    assert tint.manifest_digests(tmp_path) == (None, {})


def test_manifest_digests_and_absent_manifest(tree):
    assert tint.load_manifest(tree) is None
    assert tint.manifest_digests(tree) == (None, {})
    tint.write_manifest(tree, tint.build_manifest(tree))
    assert tint.manifest_digests(tree) == jint.manifest_digests(tree)
    mtime, digests = tint.manifest_digests(tree)
    assert mtime == (tree / "outputs.json").stat().st_mtime_ns
    assert digests["thumbnail.jpg"] == (4, tint.sha256_file(
        tree / "thumbnail.jpg"))


def test_digest_cache_validates_by_size_and_mtime(tree):
    path = tree / "master.m3u8"
    assert tint.sha256_file(path) == jint.sha256_file(path)
    tint.note_digest(path, "f" * 64)
    assert tint.sha256_file_cached(path) == "f" * 64
    assert tint.build_manifest(tree, use_cache=True)["master.m3u8"][
        "sha256"] == "f" * 64
    # verify_tree re-reads the bytes unless asked to trust the cache
    files = {"master.m3u8": {"size": 8, "sha256": "f" * 64}}
    assert tint.verify_tree(tree, files, use_cache=True) == []
    assert len(tint.verify_tree(tree, files)) == 1
    path.write_bytes(b"#EXTM3U\n#\n")                 # new size: re-hashed
    assert tint.sha256_file_cached(path) == tint.sha256_file(path)


def test_under_pressure(tmp_path, monkeypatch):
    from vlog_tpu import config as jconfig

    free = tint.free_bytes(tmp_path / "not" / "yet")    # nearest ancestor
    assert free > 0
    assert not tint.under_pressure(tmp_path, min_free=0)
    assert tint.under_pressure(tmp_path, min_free=free * 4 + (1 << 40))
    assert not tint.under_pressure(tmp_path, min_free=1)
    # the same VLOG_MIN_FREE_DISK_GB name and default as the JAX package
    assert tconfig.MIN_FREE_DISK_BYTES == jconfig.MIN_FREE_DISK_BYTES
    monkeypatch.setattr(tconfig, "MIN_FREE_DISK_BYTES", 0)
    assert not tint.under_pressure(tmp_path)
    monkeypatch.setattr(tconfig, "MIN_FREE_DISK_BYTES", free * 4 + (1 << 40))
    assert tint.under_pressure(tmp_path)
    monkeypatch.setattr(tint.shutil, "disk_usage",
                        lambda p: (_ for _ in ()).throw(OSError("gone")))
    assert tint.free_bytes(tmp_path) == 0
