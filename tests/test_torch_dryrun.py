"""The port's dry run (``vlog_tpu_torch.parallel.dryrun``) on four
logical CPU devices: its asserts pass, its records go only to the file
named, the repo's ``MULTICHIP.json`` keeps its bytes, and its sharded
step's PSNR equals the same step's on four distinct CPU device objects.
Without enough CUDA devices the entry point raises.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from tests.test_torch_backend import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_dryrun_on_four_logical_cpu_devices(tmp_path, monkeypatch):
    from vlog_tpu_torch.parallel import dryrun

    multichip = ROOT / "MULTICHIP.json"
    before = multichip.read_bytes()
    monkeypatch.chdir(tmp_path)          # the reference writes in the cwd
    records = tmp_path / "records.json"
    rec = dryrun.run(4, devices=["cpu"] * 4, records=records, iters=1)
    assert rec["multichip"] == "ok" and rec["devices"] == 4
    assert set(rec["psnr"]) == {"64p", "32p"}
    assert all(10.0 < p < 99.0 for p in rec["psnr"].values())
    full = rec["shape_fps"]["full"]
    assert set(full) == {"1x1", "2x1", "4x1", "2x2", "1x4"}
    assert set(rec["shape_fps"]["small_batch"]) == set(full)
    assert rec["sched"]["serial_widths"] == [4, 4]
    assert rec["sched"]["slot_widths"] == [2, 2]
    written = json.loads(records.read_text())
    steps = {r["step"] for r in written}
    assert {"full:2x2", "small_batch:1x4", "sched_packing"} <= steps
    assert all(r["config"]["distinct_devices"] == 1 for r in written)
    assert multichip.read_bytes() == before
    assert sorted(p.name for p in tmp_path.iterdir()) == ["records.json"]
    # the sharded step alone on four distinct device objects: the same
    # PSNR (the partials add up in the same data order)
    from vlog_tpu_torch.parallel.ladder import sharded_ladder_step, valid_mask
    from vlog_tpu_torch.parallel.mesh import make_mesh
    import numpy as np

    devs = [torch.device("cpu", i) for i in range(4)]
    step, mats = sharded_ladder_step(make_mesh("data:-1", devices=devs),
                                     dryrun.RUNGS, 96, 128)
    rng = np.random.default_rng(1)
    y = rng.integers(0, 256, (4, 96, 128)).astype(np.uint8)
    u = rng.integers(0, 256, (4, 48, 64)).astype(np.uint8)
    v = rng.integers(0, 256, (4, 48, 64)).astype(np.uint8)
    _, stats = step(y, u, v, mats, valid_mask(4, 4))
    assert {k: float(s) for k, s in stats.items()} == rec["psnr"]


def test_dryrun_needs_its_cuda_devices():
    from vlog_tpu_torch.parallel import dryrun

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"need {have + 1} CUDA devices"):
        dryrun.run(have + 1)
    with pytest.raises(ValueError, match="need 4 devices"):
        dryrun.run(4, devices=["cpu"] * 2)
