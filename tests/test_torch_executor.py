"""The port's ``PipelineExecutor`` against the JAX package's, driven by
the same scripted ``pull`` / ``process`` / ``ready`` / ``on_batch_done``
callbacks (no device work): per-rung order, the ``on_batch_done``
sequence, which batches a failure skips, the aux-task failure at drain,
pad-waste accounting and the rate-control lag schedule must be the
same at depths 1, 2 and 3. Then the port's own pieces on CPU tensors:
``start_d2h`` / ``HostCopy``, ``DecodePrefetch`` and ``upload``.
Tolerance: exact (host-only bookkeeping)."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from vlog_tpu.parallel import executor as jex
from vlog_tpu_torch.parallel import executor as tex
from vlog_tpu_torch.utils import failpoints as tfp

RUNGS = ("a", "b", "c")
DEPTHS = (1, 2, 3)


def _script(mod, depth: int, n_batches: int = 9, *, fail_at=None,
            fail_rung="b", fail_in="process"):
    """Run one scripted executor; returns (per-rung consumed indices,
    on_batch_done indices, ready calls, error, gauges, prof)."""
    order = {r: [] for r in RUNGS}
    done, ready = [], []
    lock = threading.Lock()

    def pull(name, batch):
        if fail_in == "pull" and batch.index == fail_at and name == fail_rung:
            raise RuntimeError("pull died")
        return (name, batch.index)

    def process(name, batch, host):
        assert host == (name, batch.index)
        # rungs at different speeds, so the interleaving varies
        time.sleep({"a": 0.002, "b": 0.0005, "c": 0.001}[name])
        if fail_in == "process" and batch.index == fail_at \
                and name == fail_rung:
            raise RuntimeError("stage died")
        order[name].append(batch.index)

    def on_ready(batch):
        with lock:
            ready.append(batch.index)

    prof: dict = {}
    pipe = mod.PipelineExecutor(
        RUNGS, pull=pull, process=process, ready=on_ready,
        on_batch_done=lambda b: done.append(b.index), depth=depth,
        host_threads=2, prof=prof)
    error = None
    try:
        for i in range(n_batches):
            pipe.reserve()
            pipe.note_pad_waste(6 + i % 3, 8)
            pipe.submit(None, n_real=1, qps={"i": i})
        pipe.drain()
    except RuntimeError as exc:
        error = str(exc)
    finally:
        pipe.close()
    return order, done, sorted(ready), error, pipe.gauges(), prof


@pytest.mark.parametrize("depth", DEPTHS)
def test_same_order_and_completion_sequence(depth):
    jo, jd, jr, je, jg, jp = _script(jex, depth)
    to, td, tr, te, tg, tp = _script(tex, depth)
    assert to == jo == {r: list(range(9)) for r in RUNGS}
    assert td == jd == list(range(9))        # serialized, in batch order
    assert tr == jr == list(range(9))        # ready once per batch
    assert te is je is None
    for g in (jg, tg):
        assert g["pipeline_depth"] == depth
        assert 1 <= g["max_in_flight"] <= depth
    assert set(tg) == set(jg)
    assert set(tp) == set(jp)                 # stage keys, rung_*_s, pad_frames
    assert tp["pad_frames"] == jp["pad_frames"] == 9 * 8 - sum(
        6 + i % 3 for i in range(9))


@pytest.mark.parametrize("fail_in", ["process", "pull"])
@pytest.mark.parametrize("depth", DEPTHS)
def test_stage_failure_surfaces_and_drains(depth, fail_in):
    """A consumer failure reaches the dispatch thread; batches after it
    are skipped by every rung and never reported done; close() joins."""
    want = _script(jex, depth, fail_at=3, fail_in=fail_in)
    got = _script(tex, depth, fail_at=3, fail_in=fail_in)
    msg = "stage died" if fail_in == "process" else "pull died"
    assert got[3] == want[3] == msg
    for res in (want, got):
        order, done = res[0], res[1]
        assert done == list(range(len(done))) and max(done, default=-1) < 3
        assert 3 not in order["b"]
        for r in RUNGS:
            # each rung consumed a prefix, never a batch past the failure
            # window (depth batches may be in flight when it fails)
            assert order[r] == list(range(len(order[r])))
            assert len(order[r]) <= 3 + depth
    assert not [t for t in threading.enumerate()
                if t.name.startswith("vlog-pipe-")]


@pytest.mark.parametrize("mod", [jex, tex], ids=["jax", "torch"])
def test_aux_failure_surfaces_at_drain(mod):
    def boom():
        raise ValueError("aux died")

    ran = []
    pipe = mod.PipelineExecutor(["r"], pull=lambda n, b: None,
                                process=lambda n, b, h: ran.append(b.index),
                                depth=2, host_threads=1)
    try:
        pipe.submit_aux(boom)
        pipe.reserve()
        pipe.submit(None, n_real=1)
        with pytest.raises(ValueError, match="aux died"):
            pipe.drain()
    finally:
        pipe.close()
    assert ran == [0]


def test_pad_waste_gauge_and_prof():
    """The padded fraction lands on the port's ``vlog_ladder_pad_waste``
    gauge and the padded frames accumulate in the profile, as the
    reference's."""
    from vlog_tpu_torch.obs.metrics import HAVE_PROMETHEUS, runtime

    for mod in (jex, tex):
        prof: dict = {}
        pipe = mod.PipelineExecutor(["r"], pull=lambda n, b: None,
                                    process=lambda n, b, h: None,
                                    depth=1, host_threads=1, prof=prof)
        try:
            pipe.note_pad_waste(2, 8)
            assert prof["pad_frames"] == 6
            if mod is tex and HAVE_PROMETHEUS:
                assert runtime().ladder_pad_waste._value.get() == 0.75
            pipe.note_pad_waste(8, 8)
            assert prof["pad_frames"] == 6
            if mod is tex and HAVE_PROMETHEUS:
                assert runtime().ladder_pad_waste._value.get() == 0.0
        finally:
            pipe.close()


@pytest.mark.parametrize("depth", DEPTHS)
def test_depth_bounds_the_window(depth):
    """No more than ``depth`` batches are ever in flight, counted from
    reserve(): at depth 1 the loop is serial."""
    active, peak = [], []
    lock = threading.Lock()

    def process(name, batch, host):
        with lock:
            active.append(batch.index)
            peak.append(len(active))
        time.sleep(0.002)
        with lock:
            active.remove(batch.index)

    pipe = tex.PipelineExecutor(["r"], pull=lambda n, b: None,
                                process=process, depth=depth, host_threads=1)
    try:
        for _ in range(6):
            pipe.reserve()
            time.sleep(0.003)           # a dispatch that takes a while
            pipe.submit(None, n_real=1)
        pipe.drain()
    finally:
        pipe.close()
    assert max(peak) == 1               # one rung consumes serially
    assert 1 <= pipe.gauges()["max_in_flight"] <= depth
    if depth > 1:
        # a dispatch longer than the consume still overlaps it
        assert pipe.gauges()["max_in_flight"] >= 2


@pytest.mark.parametrize("site", ["backend.pull", "backend.entropy"])
def test_failpoint_sites_fire_in_the_consumer(site):
    tfp.reset()
    tfp.arm(site, count=1, skip=1)
    seen = []
    pipe = tex.PipelineExecutor(["r"], pull=lambda n, b: b.index,
                                process=lambda n, b, h: seen.append(h),
                                depth=2, host_threads=1)
    try:
        with pytest.raises(tfp.FailpointError, match=site):
            for _ in range(4):
                pipe.reserve()
                pipe.submit(None, n_real=1)
            pipe.drain()
    finally:
        pipe.close()
        fires = tfp.counters()[site]["fires"]
        tfp.reset()
    assert fires == 1 and seen == [0]
    assert tfp.arm_from_spec(f"{site}=1") == [site]
    tfp.reset()


@pytest.mark.parametrize("lag", [1, 2, 3])
def test_lagged_rate_control_same_schedule(lag):
    """Both packages' LaggedRateControl apply the same observations at
    the same points, with replay re-indexing the pending tail."""
    class Ctl:
        def __init__(self):
            self.seen, self.calibrated, self.hunting = [], [], False

        def observe(self, nbytes, frames, frame_qps=None):
            self.seen.append((nbytes, frames))

        def calibrate_proxy(self, nbytes, cost):
            self.calibrated.append((nbytes, cost))

    logs = []
    for mod in (jex, tex):
        ctl = Ctl()
        rc = mod.LaggedRateControl({"r": ctl})
        trace = []
        for i in range(7):
            rc.apply_upto(i - lag)
            trace.append(len(ctl.seen))
            rc.post("r", i, nbytes=100 + i, frames=8,
                    cost=float(i) if i % 2 else None)
        entries = {k: {"r": {"bytes": 100 + k, "frames": 8,
                             "cost": float(k) if k % 2 else None}}
                   for k in range(7)}
        replayed = Ctl()
        mod.LaggedRateControl({"r": replayed}).replay(entries, 5, lag)
        logs.append((trace, ctl.seen, ctl.calibrated, replayed.seen))
    assert logs[0] == logs[1]


def test_start_d2h_on_cpu_tensors_reads_them():
    t = {"x": {"a": torch.arange(6, dtype=torch.int16).reshape(2, 3),
               "b": torch.ones(2)}, "y": {"a": torch.zeros(1)}}
    copy = tex.start_d2h(t)
    assert copy.stream is None
    copy.wait_compute()                      # nothing to wait for
    host = copy.host("x")
    assert isinstance(host["a"], np.ndarray) and host["a"].dtype == np.int16
    np.testing.assert_array_equal(host["a"], np.arange(6).reshape(2, 3))
    assert set(copy.host()) == {"x", "y"}
    assert tex.start_d2h(None).host() is None   # no tensors: passes through


def test_submit_starts_copies_and_pull_reads_them():
    got = []
    pipe = tex.PipelineExecutor(
        ["x"], pull=lambda n, b: b.d2h.host(n),
        process=lambda n, b, h: got.append(h["v"].tolist()),
        ready=lambda b: b.d2h.wait_compute(), depth=2, host_threads=1)
    try:
        for i in range(3):
            pipe.reserve()
            pipe.submit({"x": {"v": torch.full((2,), i)}}, n_real=1)
        pipe.drain()
    finally:
        pipe.close()
    assert got == [[0, 0], [1, 1], [2, 2]]


class _Source:
    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at

    def read_batches(self, batch, start):
        for i in range(start, self.n):
            if i == self.fail_at:
                raise OSError("decode died")
            yield (np.full((batch, 2, 2), i, np.uint8),) * 3


@pytest.mark.parametrize("maxsize", [1, 2])
def test_decode_prefetch_yields_then_none(maxsize):
    pre = tex.DecodePrefetch(_Source(5), 2, 1, maxsize=maxsize)
    try:
        got = []
        while (item := pre.get()) is not None:
            got.append(int(item[0][0, 0, 0]))
    finally:
        pre.close()
    assert got == [1, 2, 3, 4]
    assert not [t for t in threading.enumerate()
                if t.name == "vlog-decode-prefetch"]


def test_decode_prefetch_relays_errors_and_closes_early():
    pre = tex.DecodePrefetch(_Source(9, fail_at=2), 1, 0)
    try:
        assert pre.get() is not None and pre.get() is not None
        with pytest.raises(OSError, match="decode died"):
            pre.get()
    finally:
        pre.close()
    # closing with the fifo full stops a producer that never finished
    pre = tex.DecodePrefetch(_Source(1000), 1, 0, maxsize=1)
    pre.get()
    pre.close()
    assert not [t for t in threading.enumerate()
                if t.name == "vlog-decode-prefetch"]


def test_upload_and_dispatch_stream_on_cpu():
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)[:, ::2]   # not contiguous
    t = tex.upload(a, torch.device("cpu"))
    assert t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), a)
    with tex.dispatch_stream(torch.device("cpu")) as ctx:
        assert ctx is None
