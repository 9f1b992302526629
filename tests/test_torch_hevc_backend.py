"""``TorchBackend(device="cpu")`` with ``codec="h265"`` against
``JaxBackend``, and ``process_video(..., codec="h265")``.

Source: a seeded 96x128 Y4M at 10 fps, 30 frames, segments of 1 s (10-
frame I+P chains, 3 dispatches), rungs 96p (identity) and 64p (scaled),
deblock on. The seed is one whose resized 64p planes agree between the
packages (ROADMAP Queue C item 1: float32 resize sums in another order
can round a pixel the other way), checked first. ``JaxBackend`` is
pinned to one device (``grid_for_run`` -> None). Tolerance: every file
of the CMAF tree byte-identical, with rate control off and on.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pytest

from tests.fixtures.media import make_y4m, synthetic_yuv_frames
from tests.test_torch_backend import _files, one_torch_thread, rung_pair  # noqa: F401

SEED, N_FRAMES = 4, 30


@pytest.fixture(scope="module")
def source(tmp_path_factory) -> Path:
    """The Y4M, after checking that both packages resize it alike."""
    import jax.numpy as jnp
    import torch

    from vlog_tpu.ops.pallas_ladder import resize_yuv420_with
    from vlog_tpu.parallel.ladder import ladder_matrices
    from vlog_tpu_torch.ops.fused_resize import resize_yuv420
    from vlog_tpu_torch.parallel.ladder import mats_from_numpy

    frames = synthetic_yuv_frames(N_FRAMES, 128, 96, seed=SEED)
    planes = [np.stack([f[k] for f in frames]) for k in range(3)]
    rungs = (("64p", 64, 86, 31),)
    jm = ladder_matrices(rungs, 96, 128)["64p"]
    want = resize_yuv420_with(*(jnp.asarray(p) for p in planes), jm)
    got = resize_yuv420(*(torch.from_numpy(p) for p in planes),
                        mats_from_numpy({"64p": jm}, "cpu")["64p"])
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return make_y4m(tmp_path_factory.mktemp("hevc_src") / "src.y4m",
                    n_frames=N_FRAMES, width=128, height=96, fps=10, seed=SEED)


def _jax(src, out, rungs, resume=False, **opts):
    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu.media.probe import get_video_info

    be = JaxBackend()
    plan = be.plan(get_video_info(src), rungs, out, segment_duration_s=1.0,
                   codec="h265", **opts)
    return plan, be.run(plan, resume=resume)


def _torch(src, out, rungs, resume=False, progress_cb=None, **opts):
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info

    be = TorchBackend(device="cpu")
    plan = be.plan(get_video_info(src), rungs, out, segment_duration_s=1.0,
                   codec="h265", **opts)
    return plan, be.run(plan, progress_cb, resume=resume)


@pytest.fixture
def single_device(monkeypatch):
    from vlog_tpu.parallel import scheduler

    monkeypatch.setattr(scheduler, "grid_for_run", lambda *a, **k: None)


def assert_same_tree(want: Path, got: Path) -> dict[str, bytes]:
    a, b = _files(want), _files(got)
    assert set(b) == set(a)
    for rel, data in b.items():
        assert data == a[rel], f"{rel} differs ({len(data)} vs {len(a[rel])})"
    return b


@pytest.mark.parametrize("bitrate", [0, 150_000])
def test_cmaf_tree_byte_identical(source, tmp_path, single_device, bitrate):
    jr, tr = rung_pair(bitrate)
    jplan, jres = _jax(source, tmp_path / "jax", jr)
    tplan, tres = _torch(source, tmp_path / "torch", tr)
    assert tplan.gop_len == jplan.gop_len == 10
    files = assert_same_tree(tmp_path / "jax", tmp_path / "torch")
    assert sum(k.endswith(".m4s") for k in files) == 6
    assert "thumbnail.jpg" in files and "rc_journal.jsonl" not in files
    assert b"hvcC" in files["96p/init.mp4"]
    for j, t in zip(jres.rungs, tres.rungs):
        assert (t.codec_string, t.achieved_bitrate, t.segment_count) == \
            (j.codec_string, j.achieved_bitrate, j.segment_count)
        assert t.codec_string.startswith("hvc1.1.6.L")
        assert t.mean_psnr_y == pytest.approx(j.mean_psnr_y, rel=1e-5)
    # the reference's keys, and the port's device-clock dispatch sums
    assert set(tres.stage_s) == set(jres.stage_s) | {"enqueue_s",
                                                     "dispatch_wall_s"}


def test_intra_gop_tree_byte_identical(source, tmp_path, single_device):
    jr, tr = rung_pair(0)
    jplan, _ = _jax(source, tmp_path / "jax", jr, gop_mode="intra",
                    thumbnail=False)
    tplan, _ = _torch(source, tmp_path / "torch", tr, gop_mode="intra",
                      thumbnail=False)
    assert tplan.gop_len == jplan.gop_len == 1
    assert_same_tree(tmp_path / "jax", tmp_path / "torch")


class _Stop(Exception):
    pass


def _stop_after_first_dispatch(done, total, msg):
    raise _Stop(done)


def test_resume_equals_uninterrupted(source, tmp_path):
    """Stopped after dispatch 1 and resumed, the port writes the tree of
    an uninterrupted run (constant QP: a resumed HEVC run starts its
    controllers cold, as the reference does)."""
    _, tr = rung_pair(0)
    _torch(source, tmp_path / "whole", tr)
    with pytest.raises(_Stop):
        _torch(source, tmp_path / "cut", tr,
               progress_cb=_stop_after_first_dispatch)
    assert len(list((tmp_path / "cut" / "96p").glob("*.m4s"))) == 1
    _, res = _torch(source, tmp_path / "cut", tr, resume=True)
    assert res.resumed_segments == 2
    assert_same_tree(tmp_path / "whole", tmp_path / "cut")


def test_resume_equals_jax_resume(source, tmp_path, single_device):
    """With rate control, both packages resume one partial tree alike
    (no thumbnail: the reference's resumed HEVC run rewrites it from the
    resume frame, ROADMAP Queue C)."""
    jr, tr = rung_pair(150_000)
    with pytest.raises(_Stop):
        _torch(source, tmp_path / "torch", tr, thumbnail=False,
               progress_cb=_stop_after_first_dispatch)
    shutil.copytree(tmp_path / "torch", tmp_path / "jax")
    _, jres = _jax(source, tmp_path / "jax", jr, resume=True, thumbnail=False)
    _, tres = _torch(source, tmp_path / "torch", tr, resume=True,
                     thumbnail=False)
    assert tres.resumed_segments == jres.resumed_segments == 2
    assert_same_tree(tmp_path / "jax", tmp_path / "torch")


@pytest.mark.parametrize("opts,match", [
    ({"streaming_format": "hls_ts"}, "CMAF-only"),
    # AV1 is ported (backends/av1_path.py); like HEVC it is CMAF-only
    ({"codec": "av1", "streaming_format": "hls_ts"}, "av1 output is CMAF-only"),
    ({"codec": "vp9"}, "unknown codec"),
])
def test_refused_options_raise(source, tmp_path, opts, match):
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info

    be = TorchBackend(device="cpu")
    _, tr = rung_pair(0)
    with pytest.raises(ValueError, match=match):
        plan = be.plan(get_video_info(source), tr, tmp_path,
                       **{"codec": "h265", **opts})
        be.run(plan)


def test_hevc_alias_and_cuda_default(source, tmp_path):
    import torch

    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info

    _, tr = rung_pair(0)
    plan = TorchBackend(device="cpu").plan(get_video_info(source), tr,
                                           tmp_path, codec="hevc")
    assert {r.codec for r in plan.rungs} == {"h265"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchBackend()


def test_process_video_h265_verifies_and_matches_jax(source, tmp_path,
                                                     single_device,
                                                     monkeypatch):
    """``process_video(..., codec="h265", device="cpu")``: verification,
    ``outputs.json`` and hvc1 ``qualities`` rows; the whole tree equals
    the JAX package's ``process_video`` (no audio track in a Y4M)."""
    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu.worker.pipeline import process_video as jprocess
    from vlog_tpu_torch.backends import base
    from vlog_tpu_torch.storage import integrity
    from vlog_tpu_torch.worker.pipeline import process_video

    monkeypatch.setattr(base, "_SELECTED", {})
    jr, tr = rung_pair(0)
    jres = jprocess(source, tmp_path / "jax", backend=JaxBackend(),
                    codec="h265", rungs=jr, segment_duration_s=1.0)
    res = process_video(source, tmp_path / "torch", device="cpu",
                        codec="h265", rungs=tr, segment_duration_s=1.0)
    rows = res.to_db_rows()
    assert [r["codec_string"] for r in rows] == \
        [r["codec_string"] for r in jres.to_db_rows()]
    assert all(r["codec_string"].startswith("hvc1.") for r in rows)
    master = (tmp_path / "torch" / "master.m3u8").read_text()
    assert "hvc1" in master and "avc1" not in master
    assert integrity.verify_tree(tmp_path / "torch",
                                 integrity.load_manifest(tmp_path / "torch")) == []
    assert_same_tree(tmp_path / "jax", tmp_path / "torch")
