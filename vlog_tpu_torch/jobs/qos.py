"""Multi-tenant QoS: tenant policy, enqueue admission, fleet snapshot (a copy of
``vlog_tpu/jobs/qos.py``).

Three concerns, one module, because they share the tenant-policy
vocabulary:

- **Tenant policy** — per-tenant fair-share weight, queue-depth cap,
  in-flight cap, and deadline budget, resolved through the
  ``SettingsService`` dot-keys ``qos.tenant.<name>.weight`` /
  ``.max_queued`` / ``.max_inflight`` / ``.deadline_budget_s`` (DB
  value wins, ``VLOG_QOS_TENANT_<NAME>_*`` env fallback, then the
  fleet-wide ``VLOG_QOS_*`` defaults in config.py). The claim query
  (jobs/claims.py) resolves policies for exactly the tenants that have
  claimable work, OUTSIDE the claim transaction — a settings read
  inside it would deadlock on the database facade's single lock.

- **Admission control** — :func:`admit_enqueue` enforces the per-tenant
  queue-depth cap at enqueue time and raises :class:`AdmissionError`
  (HTTP layers map it to 429 + Retry-After; work is never silently
  dropped). Brownout-aware degrade: while the enqueue-side
  :class:`~vlog_tpu_torch.worker.brownout.CoordinationBreaker` is open,
  tenants whose weight is below the default weight are shed FIRST —
  the cheapest load to refuse while the database recovers. The
  ``qos.flood`` failpoint fires inside this check and, when armed,
  BYPASSES admission: a chaos flood is deliberately let through so the
  claim-side starvation bound is what must protect quiet tenants.

- **Fleet snapshot / autoscale signal** — :func:`fleet_snapshot` is the
  ONE place the per-tenant queue/in-flight counts, queue-wait p99, and
  scale hint are computed; the worker ``stats`` command and
  ``GET /api/fleet/scale-hint`` both call it, so the CLI and the
  endpoint cannot drift. The hint also lands on the
  ``vlog_fleet_scale_hint`` gauge for scrapers.
"""

from __future__ import annotations

import math
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any

from vlog_tpu_torch import config
from vlog_tpu_torch.db.core import Database, now as db_now
from vlog_tpu_torch.jobs import state as js
from vlog_tpu_torch.utils import failpoints
from vlog_tpu_torch.worker.brownout import CoordinationBreaker

DEFAULT_TENANT = "default"

# An unconstrained in-flight "cap" for CASE injection: larger than any
# real batch (CLAIM_BATCH_MAX caps a single grab at well under this).
UNLIMITED = 1 << 30

# How long a claim-plan probe result is trusted before the claim path
# re-discovers the tenant mix. Bounds BOTH directions: a tenant that
# drains away stops paying the fair-share query within this, and a
# tenant enqueued by ANOTHER process (no note_enqueue in ours) starts
# being treated fairly within it — well inside the starvation bound.
PLAN_TTL_S = 1.0


class AdmissionError(RuntimeError):
    """Enqueue refused by per-tenant admission control.

    HTTP layers translate this to 429 with a ``Retry-After`` header —
    the caller is told exactly when to come back; the job is never
    silently dropped.
    """

    def __init__(self, message: str, *, tenant: str,
                 retry_after_s: float) -> None:
        super().__init__(message)
        self.tenant = tenant
        self.retry_after_s = retry_after_s


@dataclass(frozen=True)
class TenantPolicy:
    """Resolved QoS policy for one tenant (see module docstring)."""

    tenant: str
    weight: float
    max_queued: int        # 0 = unlimited
    max_inflight: int      # 0 = unlimited
    deadline_budget_s: float


def normalize_tenant(tenant: str | None) -> str:
    """Collapse empty/whitespace tenant names onto the default tenant."""
    t = (tenant or "").strip()
    return t or DEFAULT_TENANT


def _as_float(raw: Any, default: float) -> float:
    try:
        return float(raw)
    except (TypeError, ValueError):
        return default


def _as_int(raw: Any, default: int) -> int:
    try:
        return int(raw)
    except (TypeError, ValueError):
        return default


class _PolicyCache:
    """Per-database SettingsService registry.

    jobs/claims.py is pure DB logic with no aiohttp app to hang a
    service on, so the cache maps each Database facade to one
    SettingsService (60 s TTL inside the service itself). Weak keys:
    a test's throwaway database must not pin its service forever.
    """

    def __init__(self) -> None:
        # claim paths on the event loop and compute-thread stats calls
        # can race the first lookup for a database
        self._lock = threading.Lock()             # lock-order: 44
        self._services = weakref.WeakKeyDictionary()  # guarded-by: _lock
        self._plans = weakref.WeakKeyDictionary()     # guarded-by: _lock

    def service_for(self, db: Database):
        from vlog_tpu_torch.api.settings import SettingsService

        with self._lock:
            svc = self._services.get(db)
            if svc is None:
                svc = SettingsService(db)
                self._services[db] = svc
            return svc

    def cached_plan(self, db: Database):
        """(checked_at, policies|None) if fresh and clean, else None."""
        with self._lock:
            entry = self._plans.get(db)
        if entry is None:
            return None
        checked_at, policies, dirty = entry
        if dirty or time.monotonic() - checked_at >= PLAN_TTL_S:
            return None
        return (checked_at, policies)

    def store_plan(self, db: Database, policies) -> None:
        with self._lock:
            self._plans[db] = (time.monotonic(), policies, False)

    def mark_dirty(self, db: Database) -> None:
        with self._lock:
            entry = self._plans.get(db)
            if entry is not None:
                self._plans[db] = (entry[0], entry[1], True)


_policies = _PolicyCache()


def settings_for(db: Database):
    """The SettingsService the QoS plane reads tenant policy through.

    Write per-tenant overrides through THIS service (tests, bench) so
    its TTL cache sees them immediately; a bare ``SettingsService(db)``
    writes the same rows but the claim path may serve its cached view
    for up to the TTL.
    """
    return _policies.service_for(db)


async def tenant_policy(db: Database, tenant: str) -> TenantPolicy:
    """Resolve one tenant's policy (settings dot-keys over config defaults)."""
    tenant = normalize_tenant(tenant)
    svc = settings_for(db)
    base = f"qos.tenant.{tenant}."
    weight = _as_float(await svc.get(base + "weight"),
                       config.QOS_DEFAULT_WEIGHT)
    max_queued = _as_int(await svc.get(base + "max_queued"),
                         config.QOS_MAX_QUEUED)
    max_inflight = _as_int(await svc.get(base + "max_inflight"),
                           config.QOS_MAX_INFLIGHT)
    budget = _as_float(await svc.get(base + "deadline_budget_s"),
                       config.QOS_DEADLINE_BUDGET_S)
    return TenantPolicy(tenant=tenant, weight=max(weight, 0.001),
                        max_queued=max(max_queued, 0),
                        max_inflight=max(max_inflight, 0),
                        deadline_budget_s=max(budget, 0.0))


def note_enqueue(db: Database, tenant: str,
                 deadline_at: float | None) -> None:
    """Dirty the claim-plan cache when an enqueue introduces QoS state.

    Called by enqueue_job BEFORE its transaction: a non-default tenant
    or a deadline job must be visible to the very next claim (tests and
    fairness both depend on that determinism), so the cached fast-path
    verdict cannot be trusted anymore. Default-tenant no-deadline
    enqueues leave the cache alone — they are exactly the traffic the
    fast path exists for.
    """
    if tenant != DEFAULT_TENANT or deadline_at is not None:
        _policies.mark_dirty(db)


async def claim_plan(
    db: Database, base_filter: str, base_params: dict[str, Any],
) -> dict[str, TenantPolicy] | None:
    """Resolve the fair-share plan for one claim (None = fast path).

    Runs OUTSIDE the claim transaction on purpose: policy resolution
    reads the settings table through the database facade, whose lock
    the claim transaction holds for its whole duration — a settings
    read inside it would self-deadlock.

    The verdict is cached per-db for :data:`PLAN_TTL_S` (dirtied
    synchronously by :func:`note_enqueue`), so steady single-tenant
    traffic pays ZERO extra queries per claim and a multi-tenant mix
    re-discovers at most once per TTL. Consequences of the TTL, all
    bounded by it and far inside the starvation bound: a tenant
    enqueued by another process waits up to one TTL for fair-share
    treatment, a drained tenant keeps the fair-share query alive one
    TTL, and flipping the DEFAULT tenant's max_inflight on while only
    default jobs flow is seen at the next expiry.

    Returns ``None`` when only the default tenant has claimable work,
    with no deadlines and no in-flight cap: the legacy priority-DESC /
    FIFO query is strictly cheaper and ordering is identical when only
    one tenant has work.
    """
    cached = _policies.cached_plan(db)
    if cached is not None:
        return cached[1]
    tenants = await db.fetch_all(
        f"""
        SELECT tenant, COUNT(deadline_at) AS with_deadline
        FROM jobs WHERE {base_filter} GROUP BY tenant
        """,
        base_params)
    policies: dict[str, TenantPolicy] | None
    if not tenants:
        # Nothing claimable: cache the fast-path verdict. This is what
        # keeps parked long-poll rechecks (which re-run the claim on an
        # EMPTY queue, often many times a second) from paying the
        # discovery GROUP BY on every probe. Safe to trust for a TTL:
        # fast path is correct for ANY single-tenant queue, and an
        # enqueue that introduces QoS state dirties this entry
        # synchronously via note_enqueue before the row is visible.
        _policies.store_plan(db, None)
        return None
    policies = {r["tenant"]: await tenant_policy(db, r["tenant"])
                for r in tenants}
    deadlines = sum(int(r["with_deadline"] or 0) for r in tenants)
    if (len(policies) == 1 and DEFAULT_TENANT in policies
            and deadlines == 0
            and policies[DEFAULT_TENANT].max_inflight == 0):
        policies = None
    _policies.store_plan(db, policies)
    return policies


# --------------------------------------------------------------------------
# Enqueue-side brownout breaker
# --------------------------------------------------------------------------

_brownout: CoordinationBreaker | None = None
_brownout_lock = threading.Lock()


def brownout() -> CoordinationBreaker:
    """The process's enqueue-side brownout breaker (lazy singleton).

    Same class the worker claim loops use (PR-7), pointed the other
    way: enqueue-path transient DB errors feed it (jobs/claims.py
    enqueue_job), and while it is open admission sheds
    below-default-weight tenants first.
    """
    global _brownout
    if _brownout is None:
        with _brownout_lock:
            if _brownout is None:
                _brownout = CoordinationBreaker(source="enqueue")
    return _brownout


def record_enqueue_error(exc: BaseException) -> None:
    brownout().record_error(exc)


def record_enqueue_ok() -> None:
    # only touch the breaker once it exists: the happy path must not
    # construct state (or log) just to record that nothing is wrong
    if _brownout is not None:
        _brownout.record_success()


# --------------------------------------------------------------------------
# Admission control
# --------------------------------------------------------------------------

async def admit_enqueue(db: Database, tenant: str) -> None:
    """Admit or refuse one enqueue for ``tenant`` (raises AdmissionError).

    Must run OUTSIDE the enqueue transaction: the counts below go
    through the database facade, whose lock the transaction holds.
    """
    tenant = normalize_tenant(tenant)
    try:
        # chaos hook: an armed qos.flood BYPASSES admission — the flood
        # is deliberately admitted so the claim-side fair-share +
        # starvation machinery is what must hold under it
        failpoints.hit("qos.flood")
    except failpoints.FailpointError:
        return
    pol = await tenant_policy(db, tenant)
    br = _brownout
    if br is not None and br.is_open and pol.weight < config.QOS_DEFAULT_WEIGHT:
        raise AdmissionError(
            f"enqueue shed for tenant {tenant!r}: coordination plane is "
            "browned out and the tenant's fair-share weight "
            f"({pol.weight:g}) is below the default "
            f"({config.QOS_DEFAULT_WEIGHT:g})",
            tenant=tenant, retry_after_s=br.cooldown_s)
    if pol.max_queued > 0:
        queued = await db.fetch_val(
            f"""
            SELECT COUNT(*) FROM jobs
            WHERE tenant=:tn AND {js.SQL_NOT_TERMINAL}
              AND claimed_by IS NULL
            """,
            {"tn": tenant})
        if (queued or 0) >= pol.max_queued:
            raise AdmissionError(
                f"tenant {tenant!r} queue depth {queued} is at its cap "
                f"({pol.max_queued}); retry after backlog drains",
                tenant=tenant, retry_after_s=config.QOS_RETRY_AFTER_S)


# --------------------------------------------------------------------------
# Fleet snapshot + autoscale signal
# --------------------------------------------------------------------------

def _p99(vals: list[float]) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    idx = min(len(s) - 1, max(0, math.ceil(0.99 * len(s)) - 1))
    return s[idx]


async def fleet_snapshot(db: Database) -> dict:
    """Per-tenant queue state + the autoscale hint, computed once.

    The single source both the worker ``stats`` command and
    ``GET /api/fleet/scale-hint`` serve — no duplicate SQL between the
    CLI and the endpoint. Also feeds the ``vlog_fleet_scale_hint``
    gauge.
    """
    t = db_now()
    rows = await db.fetch_all(
        f"""
        SELECT tenant,
               SUM(CASE WHEN {js.SQL_CLAIMABLE} THEN 1 ELSE 0 END)
                   AS claimable,
               SUM(CASE WHEN {js.SQL_IN_BACKOFF} THEN 1 ELSE 0 END)
                   AS backoff,
               SUM(CASE WHEN {js.SQL_ACTIVELY_CLAIMED} THEN 1 ELSE 0 END)
                   AS inflight
        FROM jobs WHERE {js.SQL_NOT_TERMINAL}
        GROUP BY tenant ORDER BY tenant
        """,
        {"now": t})
    tenants = {
        r["tenant"]: {"queued": int(r["claimable"] or 0),
                      "backoff": int(r["backoff"] or 0),
                      "inflight": int(r["inflight"] or 0)}
        for r in rows}
    queued = sum(v["queued"] for v in tenants.values())
    inflight = sum(v["inflight"] for v in tenants.values())
    waits = await db.fetch_all(
        """
        SELECT duration_s FROM job_spans
        WHERE name='queue.wait' AND duration_s IS NOT NULL
          AND started_at > :cut
        """,
        {"cut": t - config.QOS_WAIT_WINDOW_S})
    p99 = _p99([float(r["duration_s"]) for r in waits])
    online = await db.fetch_val(
        "SELECT COUNT(*) FROM workers WHERE last_heartbeat_at > :cut",
        {"cut": t - config.WORKER_OFFLINE_THRESHOLD_S})
    online = int(online or 0)
    br = _brownout
    brownout_open = bool(br is not None and br.is_open)
    # Extra workers needed to bring backlog-per-worker down to the
    # target; negative = the fleet could shrink by that many and still
    # hold the target. Pressure signals (wait p99 past the starvation
    # bound, an open enqueue brownout) floor the hint at +1: the fleet
    # is visibly behind even if the instantaneous backlog looks small.
    want = math.ceil(queued / max(1, config.QOS_SCALE_TARGET))
    hint = want - online
    if p99 > config.QOS_STARVATION_S or brownout_open:
        hint = max(hint, 1)
    # A jobs-plane SLO burning error budget on both windows is the same
    # "fleet is visibly behind" signal as starvation/brownout — floor
    # the hint at +1 too. Sync read of the last evaluation (obs/slo.py);
    # never re-evaluates, never raises.
    from vlog_tpu_torch.obs import slo as slomod

    slo_alerts = [n for n in slomod.alerting_objectives()
                  if n.startswith("jobs.")]
    if slo_alerts:
        hint = max(hint, 1)
    hint = max(hint, -online)
    from vlog_tpu_torch.obs.metrics import runtime as obs_runtime

    obs_runtime().fleet_scale_hint.set(hint)
    return {
        "computed_at": t,
        "tenants": tenants,
        "queued": queued,
        "inflight": inflight,
        "workers_online": online,
        "queue_wait_p99_s": p99,
        "brownout_open": brownout_open,
        "starvation_bound_s": config.QOS_STARVATION_S,
        "slo_alerts": slo_alerts,
        "scale_hint": hint,
    }
