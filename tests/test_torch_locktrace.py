"""The port's runtime lock witness (``vlog_tpu_torch/utils/locktrace.py``)
against the JAX package's, and the port's concurrency under it.

The witness scenarios of ``tests/test_locktrace.py`` (order reports with
both stacks, the waits-for deadlock probe converging, condition
wait/notify, plain contention) run here once per witness: the reference
test module's ``locktrace`` and primitives are swapped for each
package's, every report a scenario drains is recorded, and the two
records must be equal (kind, message, locks, thread and the stacks'
labels; a deadlock's detecting thread races, so there only the kind and
the participants). The histograms and the install
round-trip are checked on the port's own registry and scheduler.

Then the port's threaded planes run on the CPU under an installed
witness (the ``lock_witness`` fixture installs it, fails the test on any
report, and uninstalls it): the scheduler's admit/acquire/fault/probe
cycle, the pipeline executor at depth 2, the delivery plane's
single-flight fills, the ASR window queue under backpressure and the
rate-control journal's concurrent rungs. Each checks that its locks
really were witnesses.
"""

from __future__ import annotations

import asyncio
import threading
import time
import types

import pytest

import tests.test_locktrace as ref_tests
from vlog_tpu.utils import locktrace as jlt
from vlog_tpu_torch.utils import locktrace as tlt

WITNESSES = {"vlog_tpu": jlt, "vlog_tpu_torch": tlt}


def _record_scenario(mod, cls_name: str, method: str, monkeypatch) -> list:
    """Run one reference scenario against ``mod``'s witness; return the
    reports it drained (and any it left behind), in order."""
    drained: list = []

    def reset_reports():
        out = mod.reset_reports()
        drained.extend(out)
        return out

    proxy = types.SimpleNamespace(
        reports=mod.reports, reset_reports=reset_reports,
        _PROBE_S=mod._PROBE_S, install=mod.install,
        installed=mod.installed, uninstall=mod.uninstall)
    with monkeypatch.context() as m:
        m.setattr(ref_tests, "locktrace", proxy)
        m.setattr(ref_tests, "SanitizedLock", mod.SanitizedLock)
        m.setattr(ref_tests, "SanitizedCondition", mod.SanitizedCondition)
        m.setattr(ref_tests, "DeadlockError", mod.DeadlockError)
        mod.reset_reports()
        getattr(getattr(ref_tests, cls_name)(), method)()
        drained.extend(mod.reset_reports())
    return drained


def _shape(reports: list) -> list:
    """Comparable report records. Either side of a deadlock may detect
    it (or both, racing), so deadlocks reduce to one record of their
    participants."""
    out = set()
    for r in reports:
        if r.kind == "deadlock":
            out.add((r.kind, tuple(sorted(r.stacks))))
        else:
            out.add((r.kind, r.message, r.locks, r.thread,
                     tuple(r.stacks)))
    return sorted(out, key=repr)


SCENARIOS = [
    ("TestOrderWitness", "test_ordered_nesting_is_clean"),
    ("TestOrderWitness",
     "test_inverted_nesting_records_report_with_both_stacks"),
    ("TestOrderWitness", "test_unranked_locks_never_report"),
    ("TestOrderWitness", "test_two_thread_inverted_chaos"),
    ("TestDeadlockProbe", "test_ab_ba_deadlock_detected_and_converges"),
    ("TestDeadlockProbe", "test_plain_contention_is_not_a_deadlock"),
    ("TestSanitizedCondition", "test_wait_notify_across_threads"),
    ("TestSanitizedCondition", "test_wait_releases_the_held_stack"),
]


@pytest.mark.parametrize("case", SCENARIOS, ids=lambda c: f"{c[0]}.{c[1]}")
def test_witness_reports_equal_the_reference(case, monkeypatch):
    got = {pkg: _shape(_record_scenario(mod, *case, monkeypatch))
           for pkg, mod in WITNESSES.items()}
    assert got["vlog_tpu_torch"] == got["vlog_tpu"]


def test_deadlock_raises_deadlock_error_with_every_stack():
    a = tlt.SanitizedLock("t:a", 10)
    b = tlt.SanitizedLock("t:b", 20)
    barrier = threading.Barrier(2, timeout=5)
    errors: list = []

    def cross(first, second):
        with first:
            barrier.wait()
            try:
                with second:
                    pass
            except tlt.DeadlockError as exc:
                errors.append(exc)

    threads = [threading.Thread(target=cross, args=(a, b),
                                name="vlog-test-dl-a"),
               threading.Thread(target=cross, args=(b, a),
                                name="vlog-test-dl-b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert errors and all(isinstance(e, RuntimeError) for e in errors)
    reps = [r for r in tlt.reset_reports() if r.kind == "deadlock"]
    assert reps and "waits-for cycle" in reps[0].message
    assert {"vlog-test-dl-a", "vlog-test-dl-b"} <= set(reps[0].stacks)


def test_histograms_record_wait_and_hold():
    from vlog_tpu_torch.obs.metrics import runtime

    lock = tlt.SanitizedLock("test:histo", None)
    before = tlt.stats()
    with lock:
        pass
    reg = runtime().registry
    wait = reg.get_sample_value("vlog_lock_wait_seconds_count",
                                {"lock": "test:histo"})
    hold = reg.get_sample_value("vlog_lock_hold_seconds_count",
                                {"lock": "test:histo"})
    assert wait and wait >= 1
    assert hold and hold >= 1
    after = tlt.stats()
    assert after["acquisitions"] >= before["acquisitions"] + 1


def test_probe_interval_is_the_reference_default():
    assert tlt._PROBE_S == jlt._PROBE_S == 0.05


# --------------------------------------------------------------------------
# Install round-trip over the port's annotated package
# --------------------------------------------------------------------------

def test_install_swaps_annotated_inits_only():
    assert not tlt.installed()
    names = tlt.install()
    try:
        for mod in ("vlog_tpu_torch.parallel.scheduler",
                    "vlog_tpu_torch.parallel.executor",
                    "vlog_tpu_torch.asr.engine", "vlog_tpu_torch.asr.queue",
                    "vlog_tpu_torch.asr.decode",
                    "vlog_tpu_torch.backends.rc_journal",
                    "vlog_tpu_torch.delivery.plane",
                    "vlog_tpu_torch.api.catalog"):
            assert mod in names
        assert not [n for n in names if not n.startswith("vlog_tpu_torch.")]
        from vlog_tpu_torch.parallel.scheduler import MeshScheduler

        sched = MeshScheduler(devices=["cpu:0", "cpu:1"], slots=2)
        inner = sched._cond._lock
        assert isinstance(inner, tlt.SanitizedLock)
        assert inner.name == "vlog_tpu_torch/parallel/scheduler.py:_cond"
        assert inner.rank == 10
        assert isinstance(sched._pool_lock, tlt.SanitizedLock)
        assert sched._pool_lock.rank == 12
        import vlog_tpu_torch.parallel.scheduler as sched_mod
        assert sched_mod.threading.Event is threading.Event
        # the JAX package's witness and modules are untouched
        assert not jlt.installed()
    finally:
        tlt.uninstall()
    assert not tlt.installed()
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler

    raw = MeshScheduler(devices=["cpu:0"], slots=1)
    assert not isinstance(raw._cond._lock, tlt.SanitizedLock)


# --------------------------------------------------------------------------
# The port's planes under the witness
# --------------------------------------------------------------------------

@pytest.fixture
def lock_witness():
    """Install the port's witness for one test; fail it on any report."""
    assert not tlt.installed()
    tlt.install()
    before = len(tlt.reports())
    try:
        yield tlt
    finally:
        tlt.uninstall()
    fresh = tlt.reports()[before:]
    assert not fresh, "lock witness reports:\n" + "\n\n".join(
        r.render() for r in fresh)


def _witnessed(lock) -> bool:
    if isinstance(lock, threading.Condition):
        lock = lock._lock                    # the lock a Condition wraps
    return isinstance(lock, tlt.SanitizedLock)


def test_scheduler_drive_under_witness_is_clean(lock_witness):
    from vlog_tpu_torch.parallel.scheduler import MeshScheduler

    sched = MeshScheduler(devices=["cpu:0", "cpu:1"], slots=2)
    assert _witnessed(sched._cond) and _witnessed(sched._pool_lock)
    ticket = sched.admit()
    lease = ticket.acquire(timeout=10)
    assert lease is not None
    sched.report_device_fault(lease, reason="test-chaos")
    lease.release()
    ticket.close()
    sched.probe_quarantined(probe_fn=lambda devs: True)
    # two jobs at once after the probe: each waits on and takes a slot
    tickets = [sched.admit(), sched.admit()]
    got: list = []

    def job(t):
        lease = t.acquire(timeout=10)
        got.append(lease)
        time.sleep(0.01)
        lease.release()
        t.close()

    threads = [threading.Thread(target=job, args=(t,),
                                name=f"vlog-test-job-{i}")
               for i, t in enumerate(tickets)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert len(got) == 2 and all(lease is not None for lease in got)
    assert sched.capacity() >= 1
    sched.host_pool().submit(lambda: None).result(timeout=10)
    sched.host_pool().shutdown(wait=True)


def test_executor_depth_2_under_witness_is_clean(lock_witness):
    from vlog_tpu_torch.parallel import executor as tex

    rungs = ("a", "b", "c")
    order = {r: [] for r in rungs}
    done: list = []

    def process(name, batch, host):
        time.sleep({"a": 0.002, "b": 0.0005, "c": 0.001}[name])
        pipe.prof_add("entropy_s", 0.001)
        order[name].append(batch.index)

    pipe = tex.PipelineExecutor(
        rungs, pull=lambda n, b: (n, b.index), process=process,
        ready=lambda b: None, on_batch_done=lambda b: done.append(b.index),
        depth=2, host_threads=2)
    assert _witnessed(pipe._cond) and _witnessed(pipe._prof_lock)
    before = tlt.stats()["acquisitions"]
    try:
        for i in range(9):
            pipe.reserve()
            batch = pipe.submit(None, n_real=1, qps={"i": i})
            assert _witnessed(batch._ready_lock)
        pipe.drain()
    finally:
        pipe.close()
    assert order == {r: list(range(9)) for r in rungs}
    assert done == list(range(9))
    assert 1 <= pipe.gauges()["max_in_flight"] <= 2
    assert tlt.stats()["acquisitions"] > before + 9 * len(rungs)


def test_delivery_single_flight_under_witness_is_clean(lock_witness, run,
                                                       tmp_path,
                                                       monkeypatch):
    import weakref

    from tests.test_torch_delivery import publish_tree
    from vlog_tpu_torch.db import Database, create_all
    from vlog_tpu_torch.delivery import DeliveryPlane
    from vlog_tpu_torch.delivery import plane as plane_mod

    monkeypatch.setattr(plane_mod, "_PLANES", weakref.WeakSet())

    async def go():
        db = Database(f"sqlite:///{tmp_path / 'v.db'}")
        await db.connect()
        try:
            await create_all(db)
            video = await publish_tree(db, tmp_path / "videos")
            plane = DeliveryPlane(db, tmp_path / "videos")
            assert _witnessed(plane._digest_lock)
            assert _witnessed(plane._counter_lock)
            slug = video["slug"]
            want = {rel: (tmp_path / "videos" / slug / rel).read_bytes()
                    for rel in ("360p/segment_00001.m4s",
                                "360p/segment_00002.m4s")}
            got = await asyncio.gather(*[
                plane.fetch(slug, rel) for rel in want for _ in range(8)])
            assert [g.body for g in got] == [
                want[rel] for rel in want for _ in range(8)]
            # single flight: one disk read per object, the rest collapsed
            assert plane.counters["disk_reads"] == len(want)
            await plane.close()
        finally:
            await db.disconnect()

    run(asyncio.wait_for(go(), 60.0))


def test_asr_queue_backpressure_under_witness_is_clean(lock_witness):
    import numpy as np

    from vlog_tpu_torch.asr.queue import BatchKey, WindowQueue, WorkItem

    q = WindowQueue(max_items=2)
    assert _witnessed(q._cond)
    key = BatchKey("en", "transcribe", None, 1)
    n_jobs, per_job = 3, 6
    taken: list = []
    errors: list = []

    def producer(job):
        try:
            for i in range(per_job):
                q.put(key, WorkItem(job, i, float(i),
                                    np.zeros(4, np.float32)), timeout=10)
        except BaseException as exc:   # noqa: BLE001 — reported below
            errors.append(exc)

    threads = [threading.Thread(target=producer, args=(f"job{j}",),
                                name=f"vlog-test-asr-put-{j}")
               for j in range(n_jobs)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 20
    while len(taken) < n_jobs * per_job and time.monotonic() < deadline:
        if q.wait_for_work(timeout=0.1):
            k = q.pick_key()
            if k is not None:
                taken.extend(q.take(k, 2))
    for t in threads:
        t.join(10)
    q.close()
    assert not errors
    assert len(taken) == n_jobs * per_job
    for j in range(n_jobs):
        assert [w.index for w in taken if w.job == f"job{j}"] == \
            list(range(per_job))


def test_rc_journal_concurrent_rungs_under_witness_is_clean(lock_witness,
                                                             tmp_path):
    from vlog_tpu_torch.backends import rc_journal as rcj

    rungs = ["1080p", "720p", "360p"]
    header = rcj.make_header(batch_n=8, depth=2, frames_per_seg=24,
                             gop_len=24, rungs=rungs, tag="t")
    path = tmp_path / rcj.RC_JOURNAL_NAME
    journal = rcj.RCJournal(path, header)
    assert _witnessed(journal._lock)

    def consumer(rung, delay):
        for k in range(12):
            time.sleep(delay)
            journal.record(k, rung, nbytes=1000 + k, frames=8, qps=[30],
                           cost=0.5)

    threads = [threading.Thread(target=consumer, args=(r, d),
                                name=f"vlog-test-rc-{r}")
               for r, d in zip(rungs, (0.001, 0.0, 0.002))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    journal.close()
    loaded = rcj.load_journal(path)
    assert loaded is not None
    got_header, entries = loaded
    assert got_header == header
    assert sorted(entries) == list(range(12))
    assert all(set(e) == set(rungs) for e in entries.values())
