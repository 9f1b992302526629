"""Deterministic fault-injection failpoints (a copy of
``vlog_tpu/utils/failpoints.py``: the same sites).

==================  =====================================================
site                where it fires
==================  =====================================================
``claims.claim``    inside the claim transaction, after the row pick and
                    before the claim write (jobs/claims.py)
``claims.complete`` inside the completion transaction, before the
                    terminal write
``claims.fail``     inside the failure transaction, before any retry
                    accounting (a failure to record a failure)
``db.commit``       just before a transaction COMMIT (db/core.py) — the
                    armed transaction rolls back
``daemon.compute``  in WorkerDaemon._run_attempt, before the kind handler
``db.claim``        jobs.claims.claim_jobs entry — the claim query fails
                    with a synthetic connection error (the
                    coordination-plane brownout path)
``events.publish``  jobs.events.wake, before the bus publish — the armed
                    hit drops the wakeup hint (claimants degrade to
                    poll latency, no job lost)
``preempt.notice``  preemption watcher poll (worker/drain.py) — an
                    armed hit IS the eviction notice: the worker
                    begins a grace-budgeted drain
``drain.deadline``  DrainState.expired — forces the drain grace
                    deadline to fire now
``qos.flood``       qos.admit_enqueue entry (jobs/qos.py) — an armed
                    hit bypasses per-tenant admission control
``backend.encode``  at TorchBackend.run entry (worker compute thread)
``storage.verify``  at storage.integrity.verify_tree entry — forces a
                    manifest-verification rejection
``delivery.read``   in the delivery plane's cache-fill disk read
                    (delivery/plane.py) — the miss errors, the cache is
                    not poisoned, the next request retries
``delivery.shed``   at the delivery plane's admission check — forces the
                    load-shed branch (503 + Retry-After) regardless of
                    the in-flight read count
``delivery.peer``   in the delivery plane's peer fill, before the owner
                    fetch — an armed hit degrades the fill to local disk
``delivery.gossip`` in the gossip probe loop, before each heartbeat
                    (delivery/gossip.py) — the armed heartbeat is
                    dropped on the floor, so membership must converge
                    on suspicion from silence alone
``delivery.hedge``  in the peer fill, per contacted peer — the armed
                    fetch STALLS to the full peer timeout instead of
                    erroring, so the hedge to the next-ranked peer is
                    what must rescue tail latency
``device.fault``    compute thread, start of the backend ladder run
                    (worker/pipeline.py) — re-raised as a synthetic
                    CUDA-shaped device error (parallel/faults.py) so the
                    quarantine/requeue/probe loop runs end to end
``asr.submit``      JobHandle.submit (asr/engine.py), before a window
                    enters the cross-job queue; the submitting job's
                    attempt fails, the engine keeps serving others
``asr.batch``       engine tick, before the batched decode forward; every
                    job with a window in the batch gets the failure, the
                    engine survives and keeps ticking
``backend.pull``    in the pipeline executor's consumer stage, before a
                    rung's device->host pull
``backend.entropy`` in the pipeline executor's consumer stage, after the
                    pull, before the rung's host entropy coding
==================  =====================================================

:func:`arm_from_spec` (and therefore ``VLOG_FAILPOINTS``, read at
import) rejects names not in :data:`SITES`; :func:`arm` stays permissive
for tests of the trigger machinery. Spec grammar (comma/semicolon
separated)::

    site            every hit raises (no budget)
    site=N          raise on the first N hits, then stay silent
    site=pX         raise each hit with probability X; the sequence is
                    deterministic given VLOG_FAILPOINTS_SEED (default 0)
    site=skipM:...  let the first M hits pass before the trigger applies

A triggered site raises :class:`FailpointError` (a RuntimeError).
"""

from __future__ import annotations

import os
import random
import threading

ENV_VAR = "VLOG_FAILPOINTS"
SEED_VAR = "VLOG_FAILPOINTS_SEED"

SITES: dict[str, str] = {
    "claims.claim": "claim transaction, after row pick, before write",
    "claims.complete": "completion transaction, before the terminal write",
    "claims.fail": "failure transaction, before retry accounting",
    "db.commit": "just before a transaction COMMIT (rolls back)",
    "daemon.compute": "WorkerDaemon._run_attempt, before the kind handler",
    "db.claim": "claim_jobs entry; the claim query fails with a synthetic "
                "connection error",
    "events.publish": "jobs.events.wake, before the bus publish; an armed "
                      "hit drops the wakeup hint (parked claimants degrade "
                      "to re-check/poll latency)",
    "preempt.notice": "preemption watcher poll (worker/drain.py); an armed "
                      "hit IS the eviction notice — the worker begins "
                      "draining",
    "drain.deadline": "DrainState.expired; forces the drain grace deadline "
                      "to fire now",
    "qos.flood": "qos.admit_enqueue entry; an armed hit BYPASSES "
                 "per-tenant admission so a chaos flood lands on the "
                 "queue and the claim-side starvation bound must hold",
    "backend.encode": "TorchBackend.run entry (worker compute thread)",
    "storage.verify": "storage.integrity.verify_tree entry",
    "storage.gc": "storage.gc.run_gc entry",
    "remote.upload": "WorkerAPIClient.upload_file, before each attempt",
    "remote.claim": "WorkerAPIClient.claim",
    "upload.corrupt": "upload body stream: first chunk bit-flipped while "
                      "the digest header stays true",
    "claim.fence": "WorkerAPIClient epoch header; the armed write sends "
                   "a stale X-Claim-Epoch",
    "checkpoint.upload": "remote uploader's incremental checkpoint post and "
                         "the drain-time flush; the armed checkpoint write "
                         "fails",
    "delivery.read": "delivery plane cache-fill, before the disk read",
    "delivery.shed": "delivery plane admission check; forces load-shed",
    "delivery.peer": "delivery plane peer fill, before the owner fetch; "
                     "an armed hit degrades the fill to local disk",
    "delivery.gossip": "gossip probe loop, before each heartbeat; the "
                       "armed heartbeat is dropped (silence -> suspicion)",
    "delivery.hedge": "peer fill, per contacted peer; the armed fetch "
                      "stalls to the peer timeout instead of erroring, "
                      "so hedging is what must rescue tail latency",
    "device.fault": "compute thread, start of the backend ladder run; "
                    "re-raised as a synthetic CUDA-shaped device error",
    "asr.submit": "JobHandle.submit, before a window enters the cross-job "
                  "queue; the submitting job's attempt fails",
    "asr.batch": "ASR engine tick, before the batched decode forward; "
                 "every job in the batch gets the failure, the engine "
                 "keeps ticking",
    "backend.pull": "pipeline executor, before a rung's device->host pull",
    "backend.entropy": "pipeline executor, before a rung's host entropy "
                       "coding",
}


class FailpointError(RuntimeError):
    """An armed failpoint fired."""

    def __init__(self, site: str):
        super().__init__(f"failpoint {site!r} triggered")
        self.site = site


class _Failpoint:
    __slots__ = ("site", "count", "prob", "skip", "hits", "fires")

    def __init__(self, site: str, *, count: int | None = None,
                 prob: float | None = None, skip: int = 0):
        self.site = site
        self.count = count      # max fires; None = unbounded
        self.prob = prob        # fire probability; None = always
        self.skip = skip        # hits to let pass before the trigger
        self.hits = 0
        self.fires = 0


_active: dict[str, _Failpoint] = {}
_lock = threading.Lock()
_rng = random.Random(0)

# Fire observers: called with the site name on every fire, outside the
# lock and before the raise (the metrics plane counts fires per site);
# an observer that raises never masks the injected fault.
_observers: list = []


def add_observer(fn) -> None:
    """Register a ``fn(site: str)`` called on every failpoint fire."""
    if fn not in _observers:
        _observers.append(fn)


def arm(site: str, *, count: int | None = None, prob: float | None = None,
        skip: int = 0) -> None:
    """Arm (or re-arm, resetting counters) one site."""
    with _lock:
        _active[site] = _Failpoint(site, count=count, prob=prob, skip=skip)


def reset() -> None:
    """Disarm every site and reseed the probability stream."""
    with _lock:
        _active.clear()
        _rng.seed(int(os.environ.get(SEED_VAR, "0") or 0))


def is_armed(site: str) -> bool:
    return site in _active


def arm_from_spec(spec: str) -> list[str]:
    """Arm sites from a spec string (see the module docstring); returns
    the site names armed. A malformed entry raises ValueError."""
    armed: list[str] = []
    for entry in spec.replace(";", ",").split(","):
        entry = entry.strip()
        if not entry:
            continue
        site, _, trig = entry.partition("=")
        site = site.strip()
        if not site:
            raise ValueError(f"failpoint spec entry {entry!r} has no site")
        if site not in SITES:
            raise ValueError(
                f"unknown failpoint site {site!r}; registered sites: "
                f"{', '.join(sorted(SITES))}")
        count: int | None = None
        prob: float | None = None
        skip = 0
        trig = trig.strip()
        if trig.startswith("skip"):
            head, _, trig = trig.partition(":")
            skip = int(head[4:])
            trig = trig.strip()
        if trig.startswith("p"):
            prob = float(trig[1:])
            if not 0.0 <= prob <= 1.0:
                raise ValueError(f"failpoint {site}: probability {prob} "
                                 "outside [0, 1]")
        elif trig:
            count = int(trig)
            if count < 0:
                raise ValueError(f"failpoint {site}: negative count")
        arm(site, count=count, prob=prob, skip=skip)
        armed.append(site)
    return armed


def hit(site: str) -> None:
    """Record a hit at ``site``; raises FailpointError when triggered."""
    if not _active:          # fast path: nothing armed anywhere
        return
    fp = _active.get(site)
    if fp is None:
        return
    with _lock:
        fp.hits += 1
        if fp.hits <= fp.skip:
            return
        if fp.count is not None and fp.fires >= fp.count:
            return
        if fp.prob is not None and _rng.random() >= fp.prob:
            return
        fp.fires += 1
    for fn in list(_observers):
        try:
            fn(site)
        except Exception:  # noqa: BLE001 — instrumentation never masks
            pass           # the injected fault
    raise FailpointError(site)


def counters() -> dict[str, dict[str, int]]:
    """Hit/fire counters per armed site."""
    with _lock:
        return {s: {"hits": fp.hits, "fires": fp.fires,
                    "budget": -1 if fp.count is None else fp.count}
                for s, fp in _active.items()}


if os.environ.get(ENV_VAR):
    _rng.seed(int(os.environ.get(SEED_VAR, "0") or 0))
    arm_from_spec(os.environ[ENV_VAR])
