"""The port's (data x rung) grid on the CPU: sharding, the host assembly
of shards, the grid program's placement on distinct device objects, the
grid cache, quarantine on a repeated device list, and the sharded step's
PSNR against the JAX package's ``psum``.

The parity helpers here (``content``, ``jax_grid``, ``torch_grid``,
``compare``) serve the per-mode files ``test_torch_grid_intra.py``,
``test_torch_grid_chain*.py`` and ``test_torch_grid_hevc.py``: the same
numpy inputs (made from a seed) go through the JAX package's
``GridProgram`` on the conftest's 8 virtual CPU devices and the port's on
``["cpu"] * k``. Both packages resize through their plain (XLA einsum /
PyTorch) planes; the inputs are the first frames of ``content(seed=1)``,
on which both packages' resized planes are identical at every sweep rung
(``assert_resize_agrees``, the precondition of bit-exactness, ROADMAP
Queue C item 1). Tolerance: keys, shapes and dtypes equal; integer
outputs exact; ``sse_y`` and ``cost`` (float32 sums) within rtol 1e-5
(Queue C item 2).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_backend import one_torch_thread  # noqa: F401
from vlog_tpu_torch.parallel import ladder as tladder
from vlog_tpu_torch.parallel import mesh as tmesh

# slowlane-ok(module): 96x128 frames, at most 12 per dispatch; the JAX
# side compiles one intra step (two rungs)

H, W = 96, 128
# the dry run's sweep rungs: four, so the rung axis reaches 4 columns
RUNGS = (("96p", 96, 128, 26), ("64p", 64, 96, 28), ("48p", 48, 64, 29),
         ("32p", 32, 48, 30))
SHAPES = ((1, 1), (2, 1), (2, 2), (1, 4), (4, 2), (2, 4))
FLOAT_KEYS = ("sse_y", "cost")
SEED = 1


def content(n: int, seed: int = SEED):
    """(n, H, W) Y and (n, H/2, W/2) U, V: moving smooth texture + noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    ys, us, vs = [], [], []
    for t in range(n):
        ys.append(120 + 70 * np.sin((xx + 2 * t) / 8.0)
                  * np.cos((yy + t) / 6.0) + rng.normal(0, 4, yy.shape))
        us.append(128 + 50 * np.sin((xx[::2, ::2] + t) / 5.0))
        vs.append(128 + 50 * np.cos((yy[::2, ::2] + t) / 4.0))
    return tuple(np.clip(np.stack(p), 0, 255).astype(np.uint8)
                 for p in (ys, us, vs))


def chains(nc: int, clen: int):
    return tuple(p.reshape((nc, clen) + p.shape[1:])
                 for p in content(nc * clen))


def frame_qps(lead: tuple, seed: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    return {name: rng.integers(qp - 3, qp + 4, lead).astype(np.int32)
            for name, _, _, qp in RUNGS}


def rc_params() -> dict:
    return {name: {"budget": np.float32(1500.0), "alpha": np.float32(0.5)}
            for name, *_ in RUNGS}


def assert_resize_agrees(n: int) -> None:
    """Both packages' resized planes are identical on ``content(n)``."""
    import jax.numpy as jnp

    from vlog_tpu.ops.resize import resize_yuv420_with
    from vlog_tpu.parallel import ladder as jladder
    from vlog_tpu_torch.ops.fused_resize import resize_yuv420

    y, u, v = content(n)
    jmats = jladder.ladder_matrices(RUNGS, H, W)
    tmats = tladder.mats_from_numpy(jmats, "cpu")
    for name, *_ in RUNGS:
        want = resize_yuv420_with(jnp.asarray(y), jnp.asarray(u),
                                  jnp.asarray(v), jmats[name])
        got = resize_yuv420(torch.from_numpy(y), torch.from_numpy(u),
                            torch.from_numpy(v), tmats[name])
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def jax_grid(shape):
    """The JAX package's RungGrid over its first d*r virtual devices
    (None for 1x1)."""
    import jax

    from vlog_tpu.parallel import mesh as jmesh

    d, r = shape
    if d * r == 1:
        return None
    return jmesh.rung_grid(RUNGS, jmesh.MeshShape(d, r),
                           jax.devices()[:d * r])


def torch_grid(shape, devices=None):
    """The port's RungGrid over ``devices`` (default ``["cpu"] * d*r``;
    None for 1x1)."""
    d, r = shape
    if d * r == 1:
        return None
    return tmesh.rung_grid(RUNGS, tmesh.MeshShape(d, r),
                           devices or ["cpu"] * (d * r))


def compare(got: dict, want: dict) -> None:
    """Port outputs (host numpy) against JAX's, per rung and key."""
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys(), name
        for k, b in want[name].items():
            a, b = got[name][k], np.asarray(b)
            assert a.shape == b.shape and a.dtype == b.dtype, (name, k)
            if k in FLOAT_KEYS:
                np.testing.assert_allclose(a, b, rtol=1e-5,
                                           err_msg=f"{name}/{k}")
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"{name}/{k}")


def shape_id(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


# --- sharding and the host assembly ------------------------------------

def test_shard_frames_splits_rows_in_data_order():
    a = np.arange(8 * 3).reshape(8, 3).astype(np.int16)
    mesh = tmesh.make_mesh("data:-1", devices=["cpu"] * 4)
    (sh,) = tmesh.shard_frames(mesh, a)
    assert isinstance(sh, tmesh.Sharded) and len(sh) == 4
    for i, t in enumerate(sh):
        np.testing.assert_array_equal(t.numpy(), a[2 * i:2 * i + 2])
    # a plain device list (repeats allowed), a tensor input
    (sh2,) = tmesh.shard_frames(["cpu", "cpu"], torch.from_numpy(a))
    assert [tuple(t.shape) for t in sh2] == [(4, 3), (4, 3)]
    with pytest.raises(ValueError, match="pad_batch"):
        tmesh.shard_frames(mesh, a[:6])
    (padded,), real = tmesh.pad_batch(4, a[:6])
    assert real == 6 and padded.shape[0] == 8
    np.testing.assert_array_equal(padded[6:], a[5:6].repeat(2, 0))


def test_host_copy_assembles_shards_in_data_order():
    from vlog_tpu_torch.parallel.executor import start_d2h, to_host

    parts = [torch.full((2, 3), i, dtype=torch.int16) for i in range(3)]
    tree = {"r": {"a": tmesh.Sharded(parts), "b": torch.arange(4)}}
    copy = start_d2h(tree)
    assert copy.stream is None and copy.streams == {}
    host = copy.host("r")
    np.testing.assert_array_equal(host["a"], np.repeat(np.arange(3), 2)[:, None]
                                  .repeat(3, 1))
    np.testing.assert_array_equal(host["b"], np.arange(4))
    np.testing.assert_array_equal(to_host(tree)["r"]["a"], host["a"])


def test_valid_mask_marks_padding():
    np.testing.assert_array_equal(tladder.valid_mask(4, 3).numpy(),
                                  [1, 1, 1, 0])
    assert tladder.valid_mask(2, 2).dtype == torch.float32


# --- placement on distinct device objects ------------------------------

def test_grid_dispatch_places_each_shard_on_its_own_device(monkeypatch):
    """Four distinct device objects (cpu:0..cpu:3, all the CPU): a 2x2
    chain grid builds each column's program (only the column's rungs'
    matrices) on each of its data devices, stages shard i of the batch
    on the column's i-th device, runs that device's program on it, and
    assembles every rung's shards in data order; the result equals the
    one-device program's. A device mix-up (a shard on another position's
    device, another column's program) fails here though every device is
    the CPU."""
    from vlog_tpu_torch.parallel import executor
    from vlog_tpu_torch.parallel.executor import to_host

    devs = [torch.device("cpu", i) for i in range(4)]
    built, staged, calls = [], [], []
    real_build = tladder.ladder_chain_program
    real_upload = executor.upload

    def build(rungs, h, w, *, search, deblock, device):
        fn, mats = real_build(rungs, h, w, search=search, deblock=deblock,
                              device=device)
        built.append((tuple(r[0] for r in rungs), device))

        def traced(y, u, v, m, qps, rc=None):
            assert m is mats, "a shard ran with another device's matrices"
            calls.append((device, tuple(qps), y.shape[0]))
            return fn(y, u, v, m, qps, rc)
        return traced, mats

    def upload(a, dev):
        if tuple(a.shape[-2:]) == (H, W):              # the luma shards
            staged.append((dev, a[:, 0, 0, 0].tolist()))
        return real_upload(a, dev)

    monkeypatch.setattr(tladder, "ladder_chain_program", build)
    monkeypatch.setattr(executor, "upload", upload)
    grid = torch_grid((2, 2), devs)
    y, u, v = chains(4, 2)
    y = y.copy()
    y[:, 0, 0, 0] = np.arange(4)          # tag each chain's first pixel
    q = frame_qps((4, 2))
    prog = tladder.ladder_chain_grid(RUNGS, H, W, search=2, grid=grid,
                                     deblock=True, device="cpu")
    assert prog.devices == tuple(devs) and prog.data == 2
    cols = [col.names for col in grid.columns]
    assert sorted(built, key=str) == sorted(
        ((names, d) for j, names in enumerate(cols)
         for d in devs[2 * j:2 * j + 2]), key=str)
    got = to_host(prog.dispatch(y, u, v, q, rc_params()))
    assert [c for c in calls] == [(devs[2 * j + i], cols[j], 2)
                                  for j in range(2) for i in range(2)]
    # the luma shards: chains 0-1 on the column's first device, 2-3 on
    # its second, for each column
    assert staged == [(devs[2 * j + i], [2 * i, 2 * i + 1])
                      for j in range(2) for i in range(2)]
    monkeypatch.setattr(tladder, "ladder_chain_program", real_build)
    fn, mats = real_build(RUNGS, H, W, search=2, deblock=True, device="cpu")
    want = to_host(fn(*(torch.from_numpy(p) for p in (y, u, v)), mats, q,
                      rc_params()))
    for name in want:
        for k in want[name]:
            np.testing.assert_array_equal(got[name][k], want[name][k],
                                          err_msg=f"{name}/{k}")


def test_grid_program_is_cached_on_its_layout():
    g1, g2 = torch_grid((2, 2)), torch_grid((2, 2))
    assert g1 is not g2 and g1 != g2        # a port Mesh hashes by identity
    p1 = tladder.ladder_encode_grid(RUNGS, H, W, g1, device="cpu")
    assert tladder.ladder_encode_grid(RUNGS, H, W, g2, device="cpu") is p1
    other = torch_grid((2, 2), [torch.device("cpu", i) for i in range(4)])
    assert tladder.ladder_encode_grid(RUNGS, H, W, other,
                                      device="cpu") is not p1
    # one device repeated: one set of matrices per column, shared
    (_, devices, progs), = tladder.ladder_encode_grid(
        RUNGS, H, W, torch_grid((4, 1)), device="cpu").columns
    assert len(devices) == 4 and len({id(m) for _, m in progs}) == 1
    # the one-device path builds anew
    a = tladder.ladder_encode_grid(RUNGS, H, W, None, device="cpu")
    assert a.label == "1x1" and a.data == 1
    assert tladder.ladder_encode_grid(RUNGS, H, W, None, device="cpu") is not a


# --- the scheduler on a repeated device list ---------------------------

def test_quarantine_on_a_repeated_device_list(monkeypatch):
    """``["cpu"] * 4``: a fault report on a 4-wide lease attributes the
    device once (not four times), and once quarantined every position of
    it is out of rotation; the probe heals it."""
    from vlog_tpu_torch import config
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler

    monkeypatch.setattr(config, "QUARANTINE_THRESHOLD", 2)
    sched = MeshScheduler(devices=["cpu"] * 4, slots=2)
    t = sched.admit()
    lease = t.acquire()
    assert lease.width == 4
    assert sched.report_device_fault(lease) == ()
    assert sched.quarantined_count() == 0
    assert sched.report_device_fault(lease) == ("cpu",)
    t.close()
    snap = sched.snapshot()
    assert snap["slots"] == 0 and sched.capacity() == 0
    assert sched.probe_quarantined(lambda d: True) == {"cpu": True}
    assert sched.snapshot()["slots"] == 2 and sched.capacity() == 2
    # distinct devices are attributed separately
    sched = MeshScheduler(devices=["cpu:0", "cpu:1"], slots=1)
    t = sched.admit()
    lease = t.acquire()
    sched.report_device_fault(lease)
    assert sched.report_device_fault(lease) == ("cpu:0", "cpu:1")
    t.close()


# --- the sharded step against the JAX package's psum -------------------

@pytest.mark.parametrize("n_real", [4, 3])
def test_sharded_step_psnr_matches_jax_psum(n_real):
    """``sharded_ladder_step`` on 4 devices (the dry run's two rungs): the
    per-rung PSNR (the per-shard partials summed in data order) within
    rtol 1e-5 of the JAX step's ``psum`` on 4 virtual devices, the levels
    exact (and ``sharded_ladder_levels``' equal to them); with 3 real
    frames padded to 4 the valid mask keeps the pad out, so the PSNR
    equals the 3 frames' on one device."""
    import jax

    from vlog_tpu.parallel import ladder as jladder
    from vlog_tpu.parallel import mesh as jmesh

    rungs = (("64p", 64, 96, 28), ("32p", 32, 48, 30))
    assert_resize_agrees(4)
    y, u, v = (p[:n_real] for p in content(4))
    (y, u, v), real = tmesh.pad_batch(4, y, u, v)
    jm = jmesh.make_mesh("data:-1", devices=jax.devices()[:4])
    jstep, jmats = jladder.sharded_ladder_step(jm, rungs, H, W, pallas=False)
    (jy, ju, jv) = jmesh.shard_frames(jm, y, u, v)
    (jvalid,) = jmesh.shard_frames(jm, np.asarray(jladder.valid_mask(4, real)))
    jout, jstats = jstep(jy, ju, jv, jmats, jvalid)
    tm = tmesh.make_mesh("data:-1", devices=["cpu"] * 4)
    tstep, tmats = tladder.sharded_ladder_step(tm, rungs, H, W)
    from vlog_tpu_torch.parallel.executor import to_host

    tout, tstats = tstep(y, u, v, tmats, tladder.valid_mask(4, real))
    tout = to_host(tout)
    lfn, lmats = tladder.sharded_ladder_levels(tm, rungs, H, W)
    levels = to_host(lfn(y, u, v, lmats))
    ostep, omats = tladder.sharded_ladder_step(
        tmesh.make_mesh("data:-1", devices=["cpu"]), rungs, H, W)
    _, ostats = ostep(y[:real], u[:real], v[:real], omats,
                      tladder.valid_mask(real, real))
    for name, *_ in rungs:
        np.testing.assert_allclose(float(tstats[name]),
                                   float(jstats[name]), rtol=1e-5)
        for k in ("luma_dc", "luma_ac", "chroma_dc", "chroma_ac",
                  "recon_y"):
            np.testing.assert_array_equal(tout[name][k],
                                          np.asarray(jout[name][k]))
            np.testing.assert_array_equal(levels[name][k], tout[name][k])
        np.testing.assert_allclose(float(tstats[name]),
                                   float(ostats[name]), rtol=1e-5)


def test_grid_cache_builds_one_program_under_contention():
    """16 threads ask for the same grid layout at once (switch interval
    shortened): one program is built and every caller gets it."""
    import sys
    import threading

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    grid_devs = [torch.device("cpu", 7)] * 4     # a layout no other test uses
    got, errors = [], []

    def ask():
        try:
            got.append(tladder.ladder_encode_grid(
                RUNGS, H, W, torch_grid((2, 2), grid_devs), device="cpu"))
        except BaseException as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    try:
        threads = [threading.Thread(target=ask) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors and len(got) == 16
    assert len({id(p) for p in got}) == 1


def test_no_lease_generic_cuda_spreads_over_every_visible_card(monkeypatch):
    """Without a scheduler (the remote worker, direct ``process_video``),
    a backend on a generic ``"cuda"`` lays its ladder out over every
    visible card, as the reference's does over ``jax.devices()``; an
    explicit card or the CPU stays one device. Two cards are simulated by
    the device count alone: nothing here touches CUDA."""
    from vlog_tpu_torch.parallel import scheduler as tsched

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    dev, grid = tsched.placement_for_run(torch.device("cuda"), RUNGS, 1)
    assert dev == cards[0] and grid.label == "2x1"
    assert grid.columns[0].mesh.devices.tolist() == cards
    # a ladder-less caller (the pipeline's audio, the daemon): the device
    assert tsched.placement_for_run(torch.device("cuda")) == (cards[0], None)
    assert tsched.placement_for_run(torch.device("cuda", 1), RUNGS, 1) == \
        (torch.device("cuda", 1), None)
    assert tsched.placement_for_run(torch.device("cpu"), RUNGS, 1) == \
        (torch.device("cpu"), None)
    # the ASR engine with no scheduler: its batches split over both cards
    from vlog_tpu_torch.asr.engine import AsrEngine

    engine = AsrEngine.__new__(AsrEngine)
    engine.scheduler, engine.device = None, cards[0]
    assert engine._batch_devices(None) == cards
    engine.device = torch.device("cpu")
    assert engine._batch_devices(None) == [torch.device("cpu")]
