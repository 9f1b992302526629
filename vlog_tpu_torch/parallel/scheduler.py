"""Mesh job scheduler: a per-process device arbiter over slot groups
(port of ``vlog_tpu/parallel/scheduler.py``; the grant logic is the
reference's, unchanged).

- ``VLOG_MESH_SLOTS`` partitions the process's devices into that many
  contiguous groups. Each admitted job leases one slot; a lone job
  (nothing else admitted) leases every healthy device whatever the knob
  says, and widths renegotiate at job boundaries.
- The worker's claim loop admits jobs only while :meth:`capacity` is
  positive, takes a :class:`SlotTicket` per claimed job, and the job's
  compute thread blocks in :meth:`SlotTicket.acquire` for its lease;
  :meth:`MeshScheduler.hold` freezes grants while a claim round runs.
- Per-slot pipeline executors share ONE host entropy pool
  (:meth:`MeshScheduler.host_pool`, ``VLOG_ENTROPY_THREADS``).
- Device-fault quarantine: a fault attributed to the hardware
  (parallel/faults.py) takes the lease's devices out of rotation after
  ``VLOG_QUARANTINE_THRESHOLD`` attributions
  (:meth:`MeshScheduler.report_device_fault`); the cheap probe
  computation (:meth:`MeshScheduler.probe_quarantined`, every
  ``VLOG_DEVICE_PROBE_INTERVAL_S`` in the worker) reinstates devices
  that compute again. On CUDA a sticky error (an illegal address)
  poisons the process's context, so there the probe keeps failing until
  the process restarts (ROADMAP Queue C). Attribution and quarantine
  are keyed by device: a device list that repeats a device (one card as
  several logical devices) gives the device one attribution per report
  however often the lease names it, and quarantining it takes every
  position of it out of rotation.

The devices are the visible CUDA devices by default and may be any
opaque objects (the tests drive the grant logic with strings). The lease
travels to the backends through a contextvar: :func:`placement_for_run`
gives a run its first device (decode, thumbnail and the other work that
stays on one device) and its (data x rung) grid from
:func:`grid_for_run` (None under a lease one device wide).
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import torch

from vlog_tpu_torch import config

__all__ = [
    "MeshScheduler", "SlotCancelled", "SlotLease", "SlotTicket",
    "current_lease", "device_for_run", "get_scheduler", "grid_for_run",
    "host_pool_for_run", "mesh_for_run", "placement_for_run",
]


class SlotCancelled(RuntimeError):
    """Raised out of :meth:`SlotTicket.acquire` when the wait is aborted
    (ticket closed from another thread, or the caller's cancel event
    fired) — the blocked compute thread must die cleanly instead of
    zombie-running on a lease granted to an already-abandoned job."""

# Slot id of a work-conserving full-mesh lease (every device).
FULL_MESH_SLOT = -1

_CURRENT: contextvars.ContextVar["SlotLease | None"] = \
    contextvars.ContextVar("vlog_mesh_lease", default=None)


def current_lease() -> "SlotLease | None":
    """The slot lease attached to the current context (or None)."""
    return _CURRENT.get()


def mesh_for_run():
    """The device mesh the current run should shard over.

    Under a slot lease: a mesh over the slot's devices (None when the
    slot is one device wide). Without a lease: a mesh over every visible
    CUDA device when there are several, else None.
    """
    from vlog_tpu_torch.parallel.mesh import make_mesh

    lease = current_lease()
    if lease is not None:
        if lease.width <= 1:
            return None
        # a plain data axis sized to the slot: a VLOG_TPU_MESH spec is
        # sized for the full device count
        return make_mesh("data:-1", devices=list(lease.devices))
    return make_mesh() if torch.cuda.device_count() > 1 else None


def grid_for_run(rungs, batch_hint: int | None = None, devices=None):
    """The (data × rung) dispatch grid the current run should use.

    Resolves the run's device set (the lease's devices under the
    scheduler; else ``devices``, default every visible CUDA device) and
    the VLOG_TPU_MESH shape against this ladder's rungs and batch hint.
    An explicit spec that does not fit a lease's width degrades to
    ``auto`` over the lease's devices.

    Returns None on a single device (the backends' one-device path) and
    stamps the lease's shape label ("1x1" then).
    """
    from vlog_tpu_torch.parallel.mesh import resolve_mesh_shape, rung_grid

    lease = current_lease()
    if lease is not None:
        devices = list(lease.devices)
    elif devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = list(devices)
    if len(devices) <= 1:
        if lease is not None:
            lease.shape = "1x1"
        return None
    rungs = tuple(rungs)
    try:
        shape = resolve_mesh_shape(None, len(devices), rungs, batch_hint)
    except ValueError:
        if lease is None:
            raise
        shape = resolve_mesh_shape("auto", len(devices), rungs, batch_hint)
    grid = rung_grid(rungs, shape, devices)
    if lease is not None:
        lease.shape = grid.label
    return grid


def placement_for_run(default: torch.device, rungs=(),
                      batch_hint: int | None = None):
    """Where a run's work goes: ``(device, grid)``.

    Under a slot lease: the lease's first device and the lease's grid
    (:func:`grid_for_run` over ``rungs``; None, stamped "1x1", when the
    lease is one device wide). Without a lease: a generic ``"cuda"``
    ``default`` (no index) spreads over every visible CUDA device when
    there are several (the reference's no-lease behaviour: ``cuda:0``
    and a grid over all of them); any other ``default`` is the one
    device, with no grid."""
    lease = current_lease()
    if lease is None:
        if (default.type == "cuda" and default.index is None
                and torch.cuda.device_count() > 1):
            # a ladder-less caller (no rungs) asks for the device alone
            return (torch.device("cuda", 0),
                    grid_for_run(rungs, batch_hint=batch_hint)
                    if rungs else None)
        return default, None
    grid = grid_for_run(rungs, batch_hint=batch_hint) \
        if rungs or lease.width <= 1 else None
    return torch.device(lease.devices[0]), grid


def device_for_run(default: torch.device, rungs=(),
                   batch_hint: int | None = None) -> torch.device:
    """The first device of :func:`placement_for_run`: the device of the
    run's one-device work (decode, audio, thumbnail)."""
    return placement_for_run(default, rungs, batch_hint)[0]


def host_pool_for_run() -> ThreadPoolExecutor | None:
    """The scheduler's shared host entropy pool when running under a
    slot lease; None otherwise (the executor then owns its own pool,
    exactly the pre-scheduler behavior)."""
    lease = current_lease()
    if lease is None:
        return None
    return lease.scheduler.host_pool()


class SlotLease:
    """One job's hold on a mesh slot (or the full mesh).

    Context-manager use attaches the lease to the current context (so
    :func:`mesh_for_run` sees it down-stack on the same thread) and
    releases the slot on exit — including on exceptions, which is what
    lets a crashed job's slot go straight back into rotation.
    """

    __slots__ = ("slot", "devices", "width", "wait_s", "scheduler",
                 "shape", "_released", "_token")

    def __init__(self, scheduler: "MeshScheduler", slot: int,
                 devices: tuple):
        self.scheduler = scheduler
        self.slot = slot
        self.devices = tuple(devices)
        self.width = len(self.devices)
        self.wait_s = 0.0
        # resolved (data x rung) grid label, stamped by grid_for_run()
        # when a backend lays its ladder out over this lease — the
        # worker attaches it to the transcode span as ``mesh.shape``
        self.shape = None
        self._released = False
        self._token = None

    @property
    def is_full_mesh(self) -> bool:
        return self.slot == FULL_MESH_SLOT

    def release(self) -> None:
        if not self._released:
            self._released = True
            self.scheduler._release(self)

    def __enter__(self) -> "SlotLease":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, *exc) -> None:
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        self.release()

    def __repr__(self) -> str:  # pragma: no cover — debugging aid
        tag = "full" if self.is_full_mesh else str(self.slot)
        return f"<SlotLease slot={tag} width={self.width}>"


class SlotTicket:
    """Admission for one claimed job, handed out by :meth:`admit`.

    The ticket counts as demand from the moment it is issued — that is
    what lets two jobs claimed in one poll round both get narrow slots
    instead of the first racing to the full mesh. ``acquire`` blocks
    (compute thread) until a slot is grantable; ``close`` is idempotent
    and must always run (it releases the lease, withdraws un-acquired
    demand, or — when another thread is still blocked in ``acquire`` —
    aborts that wait with :class:`SlotCancelled` so the demand is
    withdrawn exactly once and no lease is ever granted to a closed
    ticket)."""

    def __init__(self, scheduler: "MeshScheduler"):
        self._sched = scheduler
        # Ticket state is shared between the admitting event loop, the
        # job's compute thread (acquire) and the supervisor (close);
        # every access outside construction goes through the
        # scheduler's condition.
        self.lease: SlotLease | None = None   # guarded-by: _cond
        self._closed = False                  # guarded-by: _cond
        self._waiting = False                 # guarded-by: _cond

    def acquire(self, timeout: float | None = None,
                cancel: threading.Event | None = None) -> SlotLease:
        """Block until a slot is grantable. ``cancel``: an event polled
        while waiting (the job supervisor's cancel flag) — firing it
        aborts the wait with :class:`SlotCancelled` instead of leaving
        an uncancellable thread parked on the condition. All ticket
        state moves under the scheduler lock (the old lock-free
        ``_closed`` fast path could race a concurrent ``close`` into
        withdrawing the same demand twice — eating ANOTHER ticket's
        slot): a concurrent ``close`` now always sees either
        not-yet-waiting (it withdraws, we raise without withdrawing),
        an open wait (it aborts, we withdraw), or the granted lease
        (it releases) — exactly one of them."""
        return self._sched._acquire(self, timeout, cancel)

    def close(self) -> None:
        with self._sched._cond:
            if self._closed:
                return
            self._closed = True
            lease = self.lease
            if lease is None and not self._waiting:
                # never entered acquire: withdraw the demand here.
                # (A thread still inside acquire withdraws it itself
                # when it wakes and sees _closed — exactly once.)
                self._sched._open_tickets = max(
                    0, self._sched._open_tickets - 1)
            self._sched._cond.notify_all()
        if lease is not None:
            lease.release()


class MeshScheduler:
    """Partitions a device list into slots and arbitrates leases.

    Thread-safe by design: tickets are admitted on the worker's event
    loop, leases acquired/released from per-job compute threads.
    ``devices`` may be any opaque objects (tests drive the grant logic
    with strings); torch enters only in the default device list and probe.

    Demand granularity is per CONSUMER, not strictly per job: transcode
    jobs hold one ticket each, while the ASR engine (asr/engine.py)
    holds one ticket for every transcription job it is serving,
    acquired while its window queue has work and released at tick
    boundaries — which is why the daemon's claim loop admits tickets
    only for device-exclusive kinds and gates transcription claims on
    the engine's own activity rather than on slot capacity.
    """

    def __init__(self, devices: Sequence | None = None,
                 slots: int | None = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError("MeshScheduler needs CUDA devices (or an "
                                   "explicit device list)")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = tuple(devices)
        want = config.MESH_SLOTS if slots is None else int(slots)
        self._want_slots = max(1, want)
        self._cond = threading.Condition()        # lock-order: 10
        self._active: dict[int, SlotLease] = {}   # guarded-by: _cond
        # admitted, not yet granted
        self._open_tickets = 0                    # guarded-by: _cond
        # claim rounds freezing grants
        self._holds = 0                           # guarded-by: _cond
        # Device-fault quarantine: device -> quarantined-at (monotonic)
        # and per-device fault attributions toward the threshold.
        self._quarantined: dict = {}              # guarded-by: _cond
        self._fault_counts: dict = {}             # guarded-by: _cond
        # set on quarantine/heal; the partition renegotiates around the
        # hole at the next job boundary (no active leases)
        self._partition_dirty = False             # guarded-by: _cond
        with self._cond:
            self._rebuild_locked()
        self._host_pool: ThreadPoolExecutor | None = None  # guarded-by: _pool_lock
        self._pool_lock = threading.Lock()        # lock-order: 12
        self._metrics().mesh_slots.set(self.slots)

    def _rebuild_locked(self) -> None:
        """Recompute the slot partition over the currently healthy
        devices (caller holds ``_cond``; only safe with no active
        leases — the claim-boundary renegotiation point).

        Contiguous partition covering every healthy device: never more
        slots than devices, each slot at least one wide; when slots
        does not divide n, the first n % slots slots are one device
        wider (no silently stranded devices at full occupancy). With
        every device quarantined, slots is 0 and nothing grants until
        a probe heals one.
        """
        # guarded-by: _cond
        self._healthy: tuple = tuple(d for d in self.devices
                                     if d not in self._quarantined)
        n = len(self._healthy)
        self.slots = max(1, min(self._want_slots, n)) if n else 0
        self.slot_width = (n // self.slots) if self.slots else 0
        bounds, at = [], 0
        if self.slots:
            base, rem = divmod(n, self.slots)
            for i in range(self.slots):
                w = base + (1 if i < rem else 0)
                bounds.append((at, at + w))
                at += w
        self._slot_bounds = tuple(bounds)         # guarded-by: _cond
        self._partition_dirty = False

    def _maybe_rebuild_locked(self) -> None:
        if self._partition_dirty and not self._active:
            before = self.slots
            self._rebuild_locked()
            if self.slots != before:
                self._metrics().mesh_slots.set(self.slots)

    def _slot_healthy_locked(self, slot: int) -> bool:
        return all(d not in self._quarantined
                   for d in self._slot_devices_locked(slot))

    # ---- admission ---------------------------------------------------
    def capacity(self) -> int:
        """Jobs this scheduler can admit right now. Zero while a
        full-mesh lease runs (arrivals would only wait for the job
        boundary while hoarding a claim another worker could serve).
        Slots holding a quarantined device do not count — their work
        belongs on another worker until a probe heals them."""
        with self._cond:
            self._maybe_rebuild_locked()
            if FULL_MESH_SLOT in self._active:
                return 0
            free = sum(1 for s in range(self.slots)
                       if s not in self._active
                       and self._slot_healthy_locked(s))
            return max(0, free - self._open_tickets)

    def admit(self) -> SlotTicket:
        """Register one claimed job's demand and return its ticket."""
        with self._cond:
            self._open_tickets += 1
        return SlotTicket(self)

    @contextlib.contextmanager
    def hold(self):
        """Freeze slot grants while a claim round is in flight.

        The claim loop's capacity check, DB claim round-trips, and
        ticket admissions span several lock windows; without the hold,
        an earlier job's compute thread can acquire mid-round and pick
        its width against INCOMPLETE demand — a lone job narrowing
        itself against a claim that comes back empty, or grabbing the
        full mesh while this round's job is being claimed (then
        stranding it a whole job life). Grants wait out the hold
        (claims are ms-scale); admissions, closes, and releases flow
        normally."""
        with self._cond:
            self._holds += 1
        try:
            yield
        finally:
            with self._cond:
                self._holds = max(0, self._holds - 1)
                self._cond.notify_all()

    def snapshot(self) -> dict:
        """Stats surface (worker ``stats`` command / debugging)."""
        with self._cond:
            self._maybe_rebuild_locked()
            return {
                "slots": self.slots,
                "slot_width": self.slot_width,
                "devices": len(self.devices),
                "healthy": len(self.devices) - len(self._quarantined),
                "quarantined": len(self._quarantined),
                "active": len(self._active),
                "pending": self._open_tickets,
                "leases": {("full" if s == FULL_MESH_SLOT else s): l.width
                           for s, l in self._active.items()},
            }

    # ---- device-fault quarantine -------------------------------------
    def report_device_fault(self, lease: SlotLease, *,
                            reason: str = "") -> tuple:
        """Attribute a device-classified fault to the lease's devices.

        The runtime rarely names the sick device, so every distinct
        device of the faulting slot takes one attribution; devices reaching
        ``VLOG_QUARANTINE_THRESHOLD`` leave the rotation. Sick slots
        stop granting immediately; the partition renegotiates around
        the hole at the next job boundary. Returns the devices newly
        quarantined by this report."""
        t = time.monotonic()
        newly = []
        with self._cond:
            # once per distinct device: a repeated device is one device
            for d in dict.fromkeys(lease.devices):
                if d in self._quarantined:
                    continue
                self._fault_counts[d] = self._fault_counts.get(d, 0) + 1
                if self._fault_counts[d] >= config.QUARANTINE_THRESHOLD:
                    self._quarantined[d] = t
                    newly.append(d)
            if newly:
                self._partition_dirty = True
                self._cond.notify_all()
            count = len(self._quarantined)
        if newly:
            m = self._metrics()
            m.slot_quarantined.labels(self._slot_label(lease.slot)).inc()
            m.device_quarantined.set(count)
        return tuple(newly)

    def quarantined_count(self) -> int:
        with self._cond:
            return len(self._quarantined)

    def probe_quarantined(self, probe_fn=None) -> dict:
        """Probe every quarantined device with a cheap computation;
        passing devices rejoin the rotation (the partition renegotiates
        at the next job boundary). Returns ``{device: passed}``.
        Blocking — callers run it in a thread."""
        with self._cond:
            targets = list(self._quarantined)
        if not targets:
            return {}
        fn = probe_fn or _default_probe
        m = self._metrics()
        results, healed = {}, []
        for d in targets:
            try:
                ok = bool(fn(d))
            except Exception:  # noqa: BLE001 — a raising probe IS a
                ok = False     # failing probe; the device stays out
            results[d] = ok
            m.device_probe.labels("pass" if ok else "fail").inc()
            if ok:
                healed.append(d)
        if healed:
            with self._cond:
                for d in healed:
                    self._quarantined.pop(d, None)
                    self._fault_counts.pop(d, None)
                self._partition_dirty = True
                self._cond.notify_all()
                count = len(self._quarantined)
            m.device_quarantined.set(count)
        return results

    # ---- grant engine ------------------------------------------------
    def _slot_devices_locked(self, slot: int) -> tuple:
        lo, hi = self._slot_bounds[slot]
        return self._healthy[lo:hi]

    def _try_grant_locked(self) -> SlotLease | None:
        self._maybe_rebuild_locked()
        if not self._healthy:
            return None      # every device quarantined: wait for a probe
        if not self._active:
            # Work-conserving fallback: a lone job (this ticket is the
            # only demand) gets every healthy device, whatever the slot
            # knob says. Widths renegotiate here, at the job boundary.
            if self._open_tickets == 1 or self.slots == 1:
                return SlotLease(self, FULL_MESH_SLOT if self.slots > 1
                                 else 0,
                                 self._healthy)
            return SlotLease(self, 0, self._slot_devices_locked(0))
        if FULL_MESH_SLOT in self._active:
            return None                  # wait for the job boundary
        for slot in range(self.slots):
            if slot not in self._active and self._slot_healthy_locked(slot):
                return SlotLease(self, slot, self._slot_devices_locked(slot))
        return None

    def _acquire(self, ticket: SlotTicket, timeout: float | None,
                 cancel: threading.Event | None) -> SlotLease:
        t0 = time.monotonic()
        deadline = None if timeout is None else t0 + timeout
        with self._cond:
            # closed wins over granted: close() releases the lease but
            # leaves ticket.lease set, so the order here is what keeps
            # a cancelled job's re-acquire from returning a RELEASED
            # lease whose devices another job may already hold.
            if ticket._closed:
                # closed before the wait registered: close() already
                # withdrew the demand (it saw _waiting False) — raise
                # WITHOUT withdrawing again.
                raise SlotCancelled("ticket already closed")
            if ticket.lease is not None:
                return ticket.lease          # idempotent re-acquire
            ticket._waiting = True
            try:
                while True:
                    if ticket._closed:
                        # close() raced our wait: withdraw the demand
                        # here (close() deliberately left it to us) and
                        # die instead of running on a dead job's lease.
                        self._withdraw_locked()
                        raise SlotCancelled(
                            "slot ticket closed while waiting")
                    if cancel is not None and cancel.is_set():
                        ticket._closed = True
                        self._withdraw_locked()
                        raise SlotCancelled(
                            "job cancelled while waiting for a mesh slot")
                    lease = None
                    if self._holds == 0:
                        # grants freeze while a claim round is in
                        # flight (hold()) — width must be decided
                        # against the round's COMPLETE demand
                        lease = self._try_grant_locked()
                    if lease is not None:
                        self._open_tickets -= 1
                        self._active[lease.slot] = lease
                        # assign under the lock: close() must never see
                        # a granted-but-unassigned ticket
                        ticket.lease = lease
                        break
                    remaining = None if deadline is None \
                        else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        ticket._closed = True
                        self._withdraw_locked()
                        raise TimeoutError(
                            f"no mesh slot free within {timeout:.1f}s")
                    # bounded waits so the cancel event stays observable
                    wait_s = 0.2 if cancel is not None else remaining
                    if remaining is not None:
                        wait_s = remaining if wait_s is None \
                            else min(wait_s, remaining)
                    self._cond.wait(timeout=wait_s)
            finally:
                ticket._waiting = False
            occupancy = len(self._active)    # read under the lock
        lease.wait_s = time.monotonic() - t0
        m = self._metrics()
        m.mesh_slot_wait.observe(lease.wait_s)
        m.mesh_slot_occupancy.set(occupancy)
        m.mesh_slot_width.labels(self._slot_label(lease.slot)).set(
            lease.width)
        return lease

    def _withdraw_locked(self) -> None:
        """Remove one unit of un-granted demand (caller holds _cond)."""
        self._open_tickets = max(0, self._open_tickets - 1)
        self._cond.notify_all()

    def _release(self, lease: SlotLease) -> None:
        with self._cond:
            self._active.pop(lease.slot, None)
            occupancy = len(self._active)
            self._cond.notify_all()
        m = self._metrics()
        m.mesh_slot_occupancy.set(occupancy)
        m.mesh_slot_width.labels(self._slot_label(lease.slot)).set(0)

    @staticmethod
    def _slot_label(slot: int) -> str:
        return "full" if slot == FULL_MESH_SLOT else str(slot)

    @staticmethod
    def _metrics():
        from vlog_tpu_torch.obs.metrics import runtime

        return runtime()

    # ---- shared resources --------------------------------------------
    def host_pool(self) -> ThreadPoolExecutor:
        """One process-wide host entropy pool for every slot executor
        (``VLOG_ENTROPY_THREADS`` is sized for the whole host; two slot
        jobs each building their own pool would oversubscribe 2x)."""
        with self._pool_lock:
            if self._host_pool is None:
                self._host_pool = ThreadPoolExecutor(
                    max_workers=config.ENTROPY_THREADS,
                    thread_name_prefix="vlog-mesh-host")
            return self._host_pool


def _default_probe(device) -> bool:
    """The cheap reinstatement probe: put a tiny tensor on the device,
    reduce it, pull the result. Anything a sick device does wrong —
    allocation, launch, the pull — fails it (and a raising probe counts
    as failing in :meth:`MeshScheduler.probe_quarantined`)."""
    x = torch.arange(8, dtype=torch.float32, device=device)
    return float(x.sum().cpu()) == 28.0


_scheduler: MeshScheduler | None = None
_scheduler_lock = threading.Lock()


def get_scheduler() -> MeshScheduler:
    """The process-wide scheduler over every visible CUDA device (lazy;
    raises without CUDA)."""
    global _scheduler
    if _scheduler is None:
        with _scheduler_lock:
            if _scheduler is None:
                _scheduler = MeshScheduler()
    return _scheduler
