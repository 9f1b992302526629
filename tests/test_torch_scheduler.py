"""The port's mesh scheduler and mesh layout against the JAX package's.

Every grant script runs on string devices through both
``MeshScheduler`` s (``vlog_tpu.parallel.scheduler`` and
``vlog_tpu_torch.parallel.scheduler``) and records what a caller can
observe: the lease (slot, width, devices, full-mesh flag) of each
acquire, ``capacity()``, ``snapshot()``, the quarantine and probe
results, which waits end in ``SlotCancelled`` or ``TimeoutError``, and
what ``hold()`` delays. The two records must be equal. The mesh
functions (spec parsing, shape resolution, rung columns, grid layout,
batch padding) are compared over a parametrised grid of specs, device
counts and rung lists. Then the port's own lease plumbing:
``device_for_run``, ``grid_for_run``'s "1x1" stamp, ``mesh_for_run``,
``host_pool_for_run``, the CUDA-only defaults and the metrics.
Tolerance: exact.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from vlog_tpu import config as jconfig
from vlog_tpu.parallel import mesh as jmesh
from vlog_tpu.parallel import scheduler as jsched
from vlog_tpu_torch import config as tconfig
from vlog_tpu_torch.parallel import mesh as tmesh
from vlog_tpu_torch.parallel import scheduler as tsched

DEVS = tuple(f"d{i}" for i in range(8))
BOTH = ((jsched, jconfig), (tsched, tconfig))


def _lease(lease) -> tuple:
    return (lease.slot, lease.width, lease.devices, lease.is_full_mesh)


def _waiter(mod, ticket, out: list, **kw) -> threading.Thread:
    def run():
        try:
            out.append(("lease", _lease(ticket.acquire(**kw))))
        except mod.SlotCancelled as exc:
            out.append(("cancelled", str(exc)))
        except TimeoutError:
            out.append(("timeout",))
    th = threading.Thread(target=run)
    th.start()
    return th


def s_partition(mod):
    rec = []
    for devs, slots in ((DEVS, 2), (("a", "b"), 8), (DEVS, 3), (DEVS[:5], 4)):
        s = mod.MeshScheduler(devices=list(devs), slots=slots)
        rec.append((s.slots, s.slot_width,
                    [s._slot_devices_locked(i) for i in range(s.slots)]))
    return rec


def s_lone_job(mod):
    s = mod.MeshScheduler(devices=list(DEVS), slots=2)
    t = s.admit()
    rec = [_lease(t.acquire()), s.capacity(), s.snapshot()]
    t.close()
    return rec + [s.capacity(), s.snapshot()]


def s_two_admitted(mod):
    s = mod.MeshScheduler(devices=list(DEVS), slots=2)
    t1, t2 = s.admit(), s.admit()
    rec = [s.capacity(), _lease(t1.acquire()), _lease(t2.acquire()),
           s.snapshot()]
    t1.close()
    rec.append(s.capacity())
    t2.close()
    return rec + [s.capacity()]


def s_renegotiate(mod, waiters: int):
    s = mod.MeshScheduler(devices=list(DEVS), slots=2)
    wide = s.admit()
    rec = [_lease(wide.acquire())]
    tickets = [s.admit() for _ in range(waiters)]
    got: list = []
    threads = [_waiter(mod, t, got) for t in tickets]
    time.sleep(0.1)
    rec.append(list(got))              # blocked on the job boundary
    wide.close()
    for th in threads:
        th.join(timeout=5)
    rec.append(sorted(got))
    for t in tickets:
        t.close()
    return rec + [s.capacity()]


def s_pending_and_crash(mod):
    s = mod.MeshScheduler(devices=list(DEVS), slots=2)
    t1 = s.admit()
    rec = [s.capacity()]
    t2 = s.admit()
    rec.append(s.capacity())
    t2.close()
    rec.append(s.capacity())
    try:
        with t1.acquire():
            rec.append(mod.current_lease() is not None)
            raise RuntimeError("job died mid-flight")
    except RuntimeError:
        pass
    rec.append(mod.current_lease() is None)
    t1.close()
    return rec + [s.capacity()]


def s_timeout_and_single_slot(mod):
    s = mod.MeshScheduler(devices=list(DEVS), slots=2)
    wide = s.admit()
    wide.acquire()
    late = s.admit()
    rec = []
    try:
        late.acquire(timeout=0.05)
    except TimeoutError:
        rec.append("timeout")
    late.close()
    wide.close()
    one = mod.MeshScheduler(devices=list(DEVS), slots=1)
    t = one.admit()
    rec += [_lease(t.acquire()), one.capacity()]
    t.close()
    return rec + [s.capacity(), one.capacity()]


def s_cancel_paths(mod):
    s = mod.MeshScheduler(devices=list(DEVS), slots=2)
    rec = []
    # acquire after close never returns the released lease
    t1 = s.admit()
    t1.acquire()
    t1.close()
    t2 = s.admit()
    rec.append(_lease(t2.acquire(timeout=1)))
    try:
        t1.acquire()
    except mod.SlotCancelled:
        rec.append("closed")
    t2.close()
    # close while waiting aborts the wait exactly once
    wide = s.admit()
    wide.acquire()
    late, got = s.admit(), []
    th = _waiter(mod, late, got)
    time.sleep(0.1)
    late.close()
    wide.close()
    th.join(timeout=5)
    rec += [[g[0] for g in got], late.lease is None, s.capacity()]
    # the cancel event aborts a blocked acquire
    wide = s.admit()
    wide.acquire()
    late, got, cancel = s.admit(), [], threading.Event()
    th = _waiter(mod, late, got, cancel=cancel)
    time.sleep(0.1)
    cancel.set()
    th.join(timeout=5)
    late.close()
    wide.close()
    rec += [[g[0] for g in got], s.capacity()]
    t = s.admit()
    rec.append(_lease(t.acquire(timeout=1)))
    t.close()
    return rec


def s_hold(mod):
    s = mod.MeshScheduler(devices=list(DEVS), slots=2)
    t1, got = s.admit(), []
    with s.hold():
        th = _waiter(mod, t1, got)
        time.sleep(0.15)
        rec = [list(got)]              # grant frozen during the round
        t2 = s.admit()
    th.join(timeout=5)
    rec += [got[0][1][1], _lease(t2.acquire())[1]]
    t1.close()
    t2.close()
    return rec + [s.capacity()]


def s_quarantine(mod):
    s = mod.MeshScheduler(devices=list(DEVS), slots=2)
    t, other = s.admit(), s.admit()
    lease = t.acquire()
    rec = [_lease(lease), s.report_device_fault(lease)]
    lease.release()
    t.close()
    got = other.acquire(timeout=1.0)
    rec.append(_lease(got))
    got.release()
    other.close()
    rec += [s.capacity(), s.snapshot()]
    sick = lease.devices
    rec.append(s.probe_quarantined(probe_fn=lambda d: d in sick[:2]))
    rec.append(s.snapshot())

    def bad(d):
        raise RuntimeError("probe dispatch failed")

    rec.append(s.probe_quarantined(probe_fn=bad))
    rec.append(s.probe_quarantined(probe_fn=lambda d: True))
    return rec + [s.snapshot(), s.probe_quarantined()]


def s_all_quarantined(mod):
    s = mod.MeshScheduler(devices=list(DEVS[:4]), slots=1)
    t = s.admit()
    lease = t.acquire()
    rec = [s.report_device_fault(lease)]
    lease.release()
    t.close()
    rec.append(s.capacity())
    late = s.admit()
    try:
        late.acquire(timeout=0.1)
    except TimeoutError:
        rec.append("timeout")
    late.close()
    s.probe_quarantined(probe_fn=lambda d: True)
    rec.append(s.capacity())
    again = s.admit()
    rec.append(_lease(again.acquire(timeout=1.0)))
    again.close()
    return rec


SCRIPTS = {
    "partition": s_partition, "lone_job_full_mesh": s_lone_job,
    "two_admitted_narrow": s_two_admitted,
    "renegotiate_one_waiter": lambda m: s_renegotiate(m, 1),
    "renegotiate_two_waiters": lambda m: s_renegotiate(m, 2),
    "pending_tickets_and_crash": s_pending_and_crash,
    "timeout_and_single_slot": s_timeout_and_single_slot,
    "cancel_paths": s_cancel_paths, "hold": s_hold,
    "quarantine_and_probe": s_quarantine,
    "all_quarantined": s_all_quarantined,
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_grant_scripts_match_the_reference(name):
    want = SCRIPTS[name](jsched)
    got = SCRIPTS[name](tsched)
    assert got == want


@pytest.mark.parametrize("threshold", [1, 2, 3])
def test_threshold_gates_quarantine(monkeypatch, threshold):
    recs = []
    for mod, cfg in BOTH:
        monkeypatch.setattr(cfg, "QUARANTINE_THRESHOLD", threshold)
        s = mod.MeshScheduler(devices=list(DEVS[:4]), slots=2)
        t = s.admit()
        lease = t.acquire()
        recs.append([(s.report_device_fault(lease), s.snapshot())
                     for _ in range(threshold + 1)])
        lease.release()
        t.close()
    assert recs[0] == recs[1]
    assert recs[1][threshold - 1][0] == DEVS[:4]


# --- mesh layout -----------------------------------------------------------

SPECS = ("data:-1", "data:8", "data:2,rung:4", "data:4,rung:2", "rung:-1",
         "data:2,rung:-1", "auto", "data:1,rung:1", "data:4,model:2",
         "rung:3", "data:16")
LADDERS = {
    "6": (("2160p", 2160, 3840, 30), ("1440p", 1440, 2560, 30),
          ("1080p", 1080, 1920, 30), ("720p", 720, 1280, 31),
          ("480p", 480, 854, 32), ("360p", 360, 640, 33)),
    "4": (("1080p", 1080, 1920, 30), ("720p", 720, 1280, 31),
          ("480p", 480, 854, 32), ("360p", 360, 640, 33)),
    "1": (("360p", 360, 640, 33),),
}


def _call(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("n_devices", [1, 2, 4, 8])
@pytest.mark.parametrize("ladder", sorted(LADDERS))
def test_resolve_mesh_shape_matches(spec, n_devices, ladder):
    rungs = LADDERS[ladder]
    for hint in (None, 1, 3, 8):
        j = _call(jmesh.resolve_mesh_shape, spec, n_devices, rungs, hint)
        t = _call(tmesh.resolve_mesh_shape, spec, n_devices, rungs, hint)
        j = (j[0], (j[1].data, j[1].rung, j[1].label)) if j[0] == "ok" else j
        t = (t[0], (t[1].data, t[1].rung, t[1].label)) if t[0] == "ok" else t
        assert t == j


@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("n_cols", [1, 2, 3, 4, 6, 7])
def test_balanced_rung_columns_match(ladder, n_cols):
    rungs = LADDERS[ladder]
    assert _call(tmesh.balanced_rung_columns, rungs, n_cols) == \
        _call(jmesh.balanced_rung_columns, rungs, n_cols)


@pytest.mark.parametrize("spec", ["", "data:-1", "data:2,rung:4",
                                  " data : 4 , model:2 ", "rung:3,data"])
def test_parse_mesh_spec_matches(spec, monkeypatch):
    monkeypatch.setattr(jconfig, "TPU_MESH_SPEC", "data:-1")
    monkeypatch.setattr(tconfig, "TPU_MESH_SPEC", "data:-1")
    j, t = jmesh.parse_mesh_spec(spec), tmesh.parse_mesh_spec(spec)
    assert (t.axes, t.axis_names) == (j.axes, j.axis_names)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 4), (2, 4), (4, 2),
                                   (8, 1), (2, 3)])
@pytest.mark.parametrize("ladder", ["6", "4"])
def test_rung_grid_layout_matches(shape, ladder):
    import jax

    rungs = LADDERS[ladder]
    jg = jmesh.rung_grid(rungs, jmesh.MeshShape(*shape), jax.devices()[:8])
    tg = tmesh.rung_grid(rungs, tmesh.MeshShape(*shape), list(range(8)))
    assert tg.label == jg.label and tg.data == jg.data
    assert [c.names for c in tg.columns] == [c.names for c in jg.columns]
    assert [list(c.mesh.devices.flat) for c in tg.columns] == \
        [[d.id for d in c.mesh.devices.flat] for c in jg.columns]
    assert [c.mesh.axis_names for c in tg.columns] == \
        [tuple(c.mesh.axis_names) for c in jg.columns]
    for col in jg.columns:
        assert tg.column_of(col.names[0]).names == col.names


@pytest.mark.parametrize("spec", ["data:-1", "data:2,model:-1", "data:4",
                                  "data:3", "data:-1,model:-1", "data:16"])
def test_make_mesh_over_explicit_devices_matches(spec):
    import jax

    j = _call(jmesh.make_mesh, spec, jax.devices()[:8])
    t = _call(tmesh.make_mesh, spec, list(range(8)))
    assert t[0] == j[0]
    if j[0] == "ok":
        ids = np.vectorize(lambda d: d.id, otypes=[int])(j[1].devices)
        assert t[1].axis_names == tuple(j[1].axis_names)
        np.testing.assert_array_equal(t[1].devices.astype(int), ids)
    else:
        assert t[1] == j[1]


@pytest.mark.parametrize("n,width", [(5, 1), (5, 2), (5, 4), (8, 4), (1, 8)])
def test_pad_batch_matches(n, width):
    a = np.arange(n * 6).reshape(n, 2, 3)
    b = np.arange(n, dtype=np.uint8)
    (ja, jb), jn = jmesh.pad_batch(width, a, b)
    (ta, tb), tn = tmesh.pad_batch(width, a, b)
    assert tn == jn
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)


def test_make_mesh_default_devices_need_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")  # the default is then real
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()


# --- the port's lease plumbing -------------------------------------------

def test_grid_for_run_under_leases_matches(monkeypatch):
    """Under a lease the grid resolves over the lease's devices and its
    label is stamped on the lease; a spec too wide for the lease degrades
    to auto — as the reference does over JAX devices."""
    import jax

    rungs = LADDERS["4"]
    labels = []
    for mod, cfg, devs in ((jsched, jconfig, jax.devices()[:8]),
                           (tsched, tconfig, list(DEVS))):
        monkeypatch.setattr(cfg, "TPU_MESH_SPEC", "data:2,rung:4")
        s = mod.MeshScheduler(devices=devs, slots=2)
        t1, t2 = s.admit(), s.admit()
        rec = []
        with t1.acquire() as lease:
            grid = mod.grid_for_run(rungs, batch_hint=1)
            rec += [grid.label, lease.shape, grid.shape.n_devices <= 4]
        t1.close()
        t2.close()
        one = mod.MeshScheduler(devices=devs[:1], slots=1)
        t = one.admit()
        with t.acquire() as lease:
            rec += [mod.grid_for_run(rungs), lease.shape]
        t.close()
        labels.append(rec)
    assert labels[0] == labels[1]


def test_device_for_run_follows_the_lease():
    cpu = torch.device("cpu")
    meta = torch.device("meta")
    assert tsched.device_for_run(cpu) == cpu          # no lease
    s = tsched.MeshScheduler(devices=[meta], slots=1)
    t = s.admit()
    with t.acquire() as lease:
        assert tsched.device_for_run(cpu, LADDERS["4"], 1) == meta
        assert lease.shape == "1x1"
        assert tsched.host_pool_for_run() is s.host_pool()
        assert tsched.mesh_for_run() is None
    t.close()
    assert tsched.host_pool_for_run() is None
    # a wide lease: the run's first device and the lease's grid (the
    # default VLOG_TPU_MESH "data:-1": one column, two data devices)
    devs = [torch.device("cpu", 0), torch.device("cpu", 1)]
    wide = tsched.MeshScheduler(devices=devs, slots=1)
    t = wide.admit()
    with t.acquire() as lease:
        assert tsched.device_for_run(cpu, LADDERS["4"]) == devs[0]
        assert lease.shape == "2x1"
        dev, grid = tsched.placement_for_run(cpu, LADDERS["4"], 1)
        assert dev == devs[0] and grid.label == "2x1"
        assert [c.names for c in grid.columns] == [
            tuple(r[0] for r in LADDERS["4"])]
        assert grid.columns[0].mesh.devices.tolist() == devs
        # a ladder-less caller gets the first device and no grid
        assert tsched.placement_for_run(cpu) == (devs[0], None)
        mesh = tsched.mesh_for_run()
        assert mesh.devices.tolist() == devs and mesh.axis_names == ("data",)
    t.close()
    s.host_pool().shutdown()


def test_cuda_defaults_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsched.MeshScheduler()
    with pytest.raises(RuntimeError, match="CUDA"):
        tsched.get_scheduler()
    assert tsched.mesh_for_run() is None
    assert tsched._default_probe(torch.device("cpu")) is True


def test_scheduler_metrics_rendered():
    from vlog_tpu_torch.obs.metrics import HAVE_PROMETHEUS, runtime

    s = tsched.MeshScheduler(devices=list(DEVS), slots=2)
    t1, t2 = s.admit(), s.admit()
    t1.acquire()
    t2.acquire()
    text = runtime().render_text()
    if HAVE_PROMETHEUS:
        assert "vlog_mesh_slot_occupancy 2.0" in text
        assert 'vlog_mesh_slot_width{slot="0"} 4.0' in text
        assert "vlog_mesh_slot_wait_seconds" in text
    lease = t1.lease
    s.report_device_fault(lease)
    t1.close()
    t2.close()
    s.probe_quarantined(probe_fn=lambda d: True)
    text = runtime().render_text()
    if HAVE_PROMETHEUS:
        assert "vlog_mesh_slot_occupancy 0.0" in text
        assert "vlog_slot_quarantined_total" in text
        assert 'vlog_device_probe_total{outcome="pass"}' in text
        assert "vlog_device_quarantined 0.0" in text
