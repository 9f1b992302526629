"""``TorchBackend(device="cpu")`` under wide slot leases: the (data x
rung) grid end to end, H.264 intra and I+P chains.

Source: ``make_y4m``'s 96x128 Y4M at 10 fps, 1 s segments, the rungs of
``tests/test_torch_backend.py::rung_pair`` (96p identity, 64p scaled).
Each run goes under a port ``MeshScheduler`` lease over ``["cpu"] * k``
with ``VLOG_TPU_MESH`` set in both packages; ``JaxBackend`` runs the
same shape under a JAX scheduler lease over its first k virtual devices.

- At 2x2 (one rung per column, two data devices each): the port's tree
  equals its own one-device tree and ``JaxBackend``'s 2x2 tree; intra
  with closed-loop rate control (the intra batch is 8 frames at every
  data width, so even the journal is shape-invariant), chains at
  constant QP (their batch, and so the journal, follows the data width:
  the journal is held only against JAX's at the same shape).
- A small batch (12 frames, 0.6 s segments: two 6-frame chains) on a
  4x1 grid (padded to 4 chains) and on a 2x2 grid: the one-device tree.
- Two intra jobs admitted together to a two-slot scheduler over
  ``["cpu"] * 4`` run concurrently on 2-wide leases (2x1 grids) and
  write the trees of serialized one-device runs.

Tolerance: byte-identical files; the journal's ``cost`` within rtol 1e-5
(``tests/test_torch_backend.py::assert_journals_match``).
"""

from __future__ import annotations

import threading
from pathlib import Path

import pytest

from tests.fixtures.media import make_y4m
from tests.test_torch_backend import (JOURNAL, _files, assert_same_files,
                                      one_torch_thread, rung_pair)  # noqa: F401


@pytest.fixture
def mesh_spec(monkeypatch):
    """Set both packages' VLOG_TPU_MESH."""
    from vlog_tpu import config as jconfig
    from vlog_tpu_torch import config as tconfig

    def set_spec(spec: str) -> None:
        monkeypatch.setattr(jconfig, "TPU_MESH_SPEC", spec)
        monkeypatch.setattr(tconfig, "TPU_MESH_SPEC", spec)
    return set_spec


def torch_run(src: Path, out: Path, rungs, devices=None, **opts):
    """The port's run, under a one-slot lease over ``devices`` if given."""
    from vlog_tpu_torch.backends.torch_backend import TorchBackend
    from vlog_tpu_torch.media.probe import get_video_info
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler

    be = TorchBackend(device="cpu")
    plan = be.plan(get_video_info(src), rungs, out, **opts)
    if devices is None:
        return be.run(plan, resume=False), None
    sched = MeshScheduler(devices=devices, slots=1)
    ticket = sched.admit()
    try:
        with ticket.acquire() as lease:
            res = be.run(plan, resume=False)
            return res, lease.shape
    finally:
        ticket.close()


def jax_run(src: Path, out: Path, rungs, n_devices: int, **opts):
    """JaxBackend under a one-slot JAX lease over its first n devices."""
    import jax

    from vlog_tpu.backends.jax_backend import JaxBackend
    from vlog_tpu.media.probe import get_video_info
    from vlog_tpu.parallel.scheduler import MeshScheduler

    be = JaxBackend()
    plan = be.plan(get_video_info(src), rungs, out, **opts)
    sched = MeshScheduler(devices=jax.devices()[:n_devices], slots=1)
    ticket = sched.admit()
    try:
        with ticket.acquire() as lease:
            res = be.run(plan, resume=False)
            return res, lease.shape
    finally:
        ticket.close()


def without_journal(root: Path) -> dict[str, bytes]:
    return {k: v for k, v in _files(root).items() if k != JOURNAL}


@pytest.mark.parametrize("gop_mode", ["intra", "p"])
def test_wide_lease_tree_matches_one_device_and_jax(tmp_path, mesh_spec,
                                                    gop_mode):
    src = make_y4m(tmp_path / "src.y4m", n_frames=20, width=128, height=96,
                   fps=10)
    bitrate = 60_000 if gop_mode == "intra" else 0
    jr, tr = rung_pair(bitrate)
    opts = dict(segment_duration_s=1.0, gop_mode=gop_mode)
    mesh_spec("data:2,rung:2")
    torch_run(src, tmp_path / "one", tr, **opts)
    res, shape = torch_run(src, tmp_path / "grid", tr, ["cpu"] * 4, **opts)
    assert shape == "2x2" and res.frames_processed == 20
    _, jshape = jax_run(src, tmp_path / "jax", jr, 4, **opts)
    assert jshape == "2x2"
    files = assert_same_files(tmp_path / "jax", tmp_path / "grid")
    assert sum(k.endswith(".m4s") for k in files) == 4
    if gop_mode == "intra":
        assert _files(tmp_path / "grid") == _files(tmp_path / "one")
    else:
        assert without_journal(tmp_path / "grid") == \
            without_journal(tmp_path / "one")


def test_small_batch_on_wide_grids_matches_one_device(tmp_path, mesh_spec):
    """Two 6-frame chains: 4x1 pads them to 4 (one per data device), 2x2
    runs them unpadded with the rungs split; both write the one-device
    tree (the journal, shaped by the batch, aside)."""
    src = make_y4m(tmp_path / "src.y4m", n_frames=12, width=128, height=96,
                   fps=10)
    _, tr = rung_pair(0)
    opts = dict(segment_duration_s=0.6, gop_mode="p", frame_batch=12)
    ref, _ = torch_run(src, tmp_path / "one", tr, **opts)
    assert ref.gop_len == 6
    want = without_journal(tmp_path / "one")
    for spec, label in (("data:4,rung:1", "4x1"), ("data:2,rung:2", "2x2")):
        mesh_spec(spec)
        _, shape = torch_run(src, tmp_path / label, tr, ["cpu"] * 4, **opts)
        assert shape == label
        assert without_journal(tmp_path / label) == want, label


def test_two_concurrent_slot_jobs_match_serialized(tmp_path):
    """Two intra jobs admitted together to a two-slot scheduler over
    ``["cpu"] * 4``: each leases 2 devices (a 2x1 grid), they run at once
    (sharing the scheduler's host pool), and each writes the tree of a
    serialized one-device run."""
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler

    _, tr = rung_pair(60_000)
    opts = dict(segment_duration_s=1.0, gop_mode="intra")
    srcs = [make_y4m(tmp_path / f"src{i}.y4m", n_frames=12 + 4 * i,
                     width=128, height=96, fps=10, seed=i)
            for i in range(2)]
    refs = []
    for i, src in enumerate(srcs):
        torch_run(src, tmp_path / f"serial{i}", tr, **opts)
        refs.append(_files(tmp_path / f"serial{i}"))

    sched = MeshScheduler(devices=["cpu"] * 4, slots=2)
    tickets = [sched.admit() for _ in range(2)]
    errors, shapes = [], []
    both = threading.Barrier(2)

    def job(i: int) -> None:
        from vlog_tpu_torch.backends.torch_backend import TorchBackend
        from vlog_tpu_torch.media.probe import get_video_info

        try:
            lease = tickets[i].acquire()
            assert lease.width == 2, lease
            both.wait(timeout=30)          # both leases held at once
            with lease:
                be = TorchBackend(device="cpu")
                plan = be.plan(get_video_info(srcs[i]), tr,
                               tmp_path / f"conc{i}", **opts)
                be.run(plan, resume=False)
                shapes.append(lease.shape)
        except BaseException as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)
        finally:
            tickets[i].close()

    threads = [threading.Thread(target=job, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert shapes == ["2x1", "2x1"] and sched.capacity() == 2
    for i, ref in enumerate(refs):
        assert _files(tmp_path / f"conc{i}") == ref, i
