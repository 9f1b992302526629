"""``TorchBackend(device="cpu")`` with ``codec="h265"`` under a wide slot
lease: the HEVC ladder on a (data x rung) grid end to end.

Source: the seeded 96x128 Y4M of ``tests/test_torch_hevc_backend.py``
(whose 64p planes resize alike in both packages, checked by its
``source`` fixture), 30 frames at 10 fps, 1 s segments (10-frame
chains), rungs 96p (identity) and 64p, constant QP. Under a port lease
over ``["cpu"] * 4`` at ``VLOG_TPU_MESH=data:2,rung:2`` (each rung its
own column, its chains split over two data devices) the tree equals the
port's one-device tree and ``JaxBackend``'s under a JAX lease over its
first 4 virtual devices at the same shape; at ``data:4,rung:1`` it
equals the one-device tree too. Tolerance: byte-identical files.
"""

from __future__ import annotations

from tests.test_torch_backend import _files, one_torch_thread, rung_pair  # noqa: F401
from tests.test_torch_grid_backend import jax_run, mesh_spec, torch_run  # noqa: F401
from tests.test_torch_hevc_backend import source  # noqa: F401


def test_hevc_wide_lease_tree_matches_one_device_and_jax(source, tmp_path,
                                                         mesh_spec):
    jr, tr = rung_pair(0)
    opts = dict(segment_duration_s=1.0, codec="h265")
    torch_run(source, tmp_path / "one", tr, **opts)
    want = _files(tmp_path / "one")
    assert sum(k.endswith(".m4s") for k in want) == 6
    mesh_spec("data:2,rung:2")
    res, shape = torch_run(source, tmp_path / "grid", tr, ["cpu"] * 4, **opts)
    assert shape == "2x2" and res.frames_processed == 30
    assert _files(tmp_path / "grid") == want
    _, jshape = jax_run(source, tmp_path / "jax", jr, 4, **opts)
    assert jshape == "2x2"
    assert _files(tmp_path / "jax") == want
    mesh_spec("data:4,rung:1")
    _, shape = torch_run(source, tmp_path / "data4", tr, ["cpu"] * 4, **opts)
    assert shape == "4x1"
    assert _files(tmp_path / "data4") == want
