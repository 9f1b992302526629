"""The reference's ``WorkerDaemon`` (``JaxBackend`` on the CPU) against the
port's (a CPU ``TorchBackend``, ``device="cpu"``) on identical seeded
databases and sources.

Each daemon gets its own package's database, with the same video rows
and jobs enqueued in the same order: a transcode of a 96x128 Y4M (10
frames at 24 fps: the 360p rung plans at the source size) followed by
the sprite job its finalize enqueues, and an HEVC re-encode
(``codec="h265"``) of a second video. ``poll_once`` drains each queue.

Tolerance: every file of both output trees byte-identical, except the
rate-control journal, whose float ``cost`` fields are held to a relative
1e-5 (ROADMAP Queue C item 2; the journal is not in ``outputs.json``);
every row of ``videos``, ``jobs``, ``video_qualities``,
``quality_progress``, ``job_failures`` and ``workers`` equal except
timestamps, the output root in stored paths, and the workers'
``capabilities`` (the backends differ). The sprite tile is the one
scaled resize: the seed is one whose tile planes agree between the
packages (Queue C item 1), checked first. ``JaxBackend`` is pinned to
one device (``grid_for_run`` -> None). A Y4M has no audio, so no
transcription job and no AAC (Queue C item 13).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

from tests.fixtures.media import make_y4m, synthetic_yuv_frames
from tests.test_torch_backend import (JOURNAL, _files,  # noqa: F401
                                      assert_journals_match, one_torch_thread)

SEED, N_FRAMES, W, H = 4, 10, 128, 96


@pytest.fixture(scope="module")
def sources(tmp_path_factory) -> dict[str, Path]:
    """The two Y4Ms, after checking that both packages resize the
    sampled sprite tile alike."""
    from vlog_tpu.ops.resize import resize_yuv420 as jresize
    from vlog_tpu_torch.ops.fused_resize import resize_yuv420
    from vlog_tpu_torch.worker.sprites import _tile_mats

    frames = synthetic_yuv_frames(N_FRAMES, W, H, seed=SEED)
    planes = [np.stack([f[k] for f in frames[:1]]) for k in range(3)]
    want = jresize(*planes, 90, 160)
    got = resize_yuv420(*(torch.from_numpy(p) for p in planes),
                        _tile_mats(H, W, 90, 160, torch.device("cpu")))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    d = tmp_path_factory.mktemp("daemon_src")
    return {"transcode": make_y4m(d / "a.y4m", n_frames=N_FRAMES, width=W,
                                  height=H, fps=24, seed=SEED),
            "hevc": make_y4m(d / "b.y4m", n_frames=N_FRAMES, width=W,
                             height=H, fps=24, seed=SEED + 1)}


async def _drive(pkg: str, db_path: Path, video_dir: Path, srcs: dict):
    """Seed one package's database, drain its queue with its daemon."""
    import importlib

    imp = importlib.import_module
    dbm, claims = imp(f"{pkg}.db"), imp(f"{pkg}.jobs.claims")
    vids, enums = imp(f"{pkg}.jobs.videos"), imp(f"{pkg}.enums")
    daemon_mod = imp(f"{pkg}.worker.daemon")
    db = dbm.Database(f"sqlite:///{db_path}")
    await db.connect()
    await dbm.create_all(db)
    a = await vids.create_video(db, "Transcoded", source_path=str(
        srcs["transcode"]), size_bytes=srcs["transcode"].stat().st_size)
    b = await vids.create_video(db, "Reencoded", source_path=str(
        srcs["hevc"]), size_bytes=srcs["hevc"].stat().st_size)
    await claims.enqueue_job(db, a["id"])
    await claims.enqueue_job(db, b["id"], enums.JobKind.REENCODE,
                             payload={"codec": "h265",
                                      "streaming_format": "cmaf"})
    if pkg == "vlog_tpu":
        from vlog_tpu.backends.jax_backend import JaxBackend

        kw = {"backend": JaxBackend()}
    else:
        from vlog_tpu_torch.backends.torch_backend import TorchBackend

        kw = {"backend": TorchBackend(device="cpu"), "device": "cpu"}
    daemon = daemon_mod.WorkerDaemon(db, name="parity-w", video_dir=video_dir,
                                     progress_min_interval_s=0.0, **kw)
    ran = 0
    while await daemon.poll_once():
        ran += 1
    rows = {t: await db.fetch_all(f"SELECT * FROM {t} ORDER BY 1") for t in
            ("videos", "jobs", "video_qualities", "quality_progress",
             "job_failures", "workers")}
    spans = await db.fetch_all(
        "SELECT job_id, name FROM job_spans ORDER BY job_id, name")
    await db.disconnect()
    return ran, rows, spans


def _normalize(rows: dict, root: Path) -> dict:
    out = {}
    for table, rs in rows.items():
        out[table] = []
        for r in rs:
            r = {k: (v.replace(str(root), "<root>") if isinstance(v, str)
                     else v)
                 for k, v in r.items()
                 if not k.endswith("_at") and k != "capabilities"}
            out[table].append(r)
    return out


def test_daemons_write_identical_trees_and_rows(sources, tmp_path,
                                                monkeypatch):
    import asyncio

    from vlog_tpu.parallel import scheduler

    monkeypatch.setattr(scheduler, "grid_for_run", lambda *a, **k: None)
    results = {}
    for pkg in ("vlog_tpu", "vlog_tpu_torch"):
        root = tmp_path / pkg
        results[pkg] = asyncio.run(_drive(pkg, tmp_path / f"{pkg}.db",
                                          root / "videos", sources))
        results[pkg] = (*results[pkg], root)
    (jran, jrows, jspans, jroot), (tran, trows, tspans, troot) = (
        results["vlog_tpu"], results["vlog_tpu_torch"])
    assert jran == tran == 3              # transcode, re-encode, sprite
    assert all(r["completed_at"] for r in trows["jobs"]), trows["jobs"]
    assert [r["kind"] for r in trows["jobs"]] == ["transcode", "reencode",
                                                  "sprite"]
    for slug, must in (("transcoded", ("sprites/sprite_01.jpg",
                                       "360p/init.mp4", JOURNAL)),
                       ("reencoded", ("360p/init.mp4",))):
        want = _files(jroot / "videos" / slug)
        got = _files(troot / "videos" / slug)
        assert set(got) == set(want), slug
        assert all(m in got for m in must), (slug, sorted(got))
        for rel, data in got.items():
            if rel == JOURNAL:
                assert_journals_match(want[rel], data)
            else:
                assert data == want[rel], f"{slug}/{rel} differs"
    assert b"hvcC" in _files(troot / "videos" / "reencoded")["360p/init.mp4"]
    assert _normalize(trows, troot) == _normalize(jrows, jroot)
    assert tspans == jspans
