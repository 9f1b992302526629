"""Claim protocol: atomic claim / progress / complete / fail over the DB (a copy of
``vlog_tpu/jobs/claims.py``).

Reference parity: api/worker_api.py:1374-2074 — the claim transaction
(expired-claim sweep + ``FOR UPDATE SKIP LOCKED`` select + claim write),
lease extension on progress, and completion/failure with retry accounting.
In sqlite the ``BEGIN IMMEDIATE`` transaction is the serialization point
(single writer), so two workers can never claim the same row.

Failure plane: every failed attempt is stamped with jittered exponential
backoff (``next_retry_at``; the job derives BACKOFF until due — see
jobs/state.py) and recorded in ``job_failures`` with a classification
(:class:`vlog_tpu_torch.enums.FailureClass`). The expired-claim sweep
attributes lapsed leases to ``worker_crash`` so a dead worker's jobs
carry a post-mortem even though nobody reported the failure. Chaos
hooks: failpoints ``claims.claim`` / ``claims.complete`` /
``claims.fail`` fire inside the respective transactions
(utils/failpoints.py).

All functions are pure DB logic — no HTTP, no media. The Worker API service
wraps these; local in-process workers call them directly, mirroring how the
reference's local transcoder bypassed the HTTP plane.
"""

from __future__ import annotations

import asyncio
import json
import logging
import random
import sqlite3
from typing import Any, Awaitable, Callable

from vlog_tpu_torch import config
from vlog_tpu_torch.db.core import Database, Row, now as db_now
from vlog_tpu_torch.enums import AcceleratorKind, FailureClass, JobKind
from vlog_tpu_torch.jobs import qos, state as js
from vlog_tpu_torch.jobs.events import CH_JOBS, CH_PROGRESS, wake as _wake
from vlog_tpu_torch.obs import store as obs_store
from vlog_tpu_torch.obs.metrics import runtime as obs_runtime
from vlog_tpu_torch.utils import failpoints

log = logging.getLogger("vlog_tpu_torch.claims")


async def _trace_write(label: str, fn: Callable[[], Awaitable[Any]]) -> None:
    """Best-effort post-commit span write.

    These run AFTER the state transaction committed, inside callables
    that with_retries may re-run — a raising trace write would re-run
    an already-applied claim/complete/fail (double-claim, or a
    committed completion reported as 409/failure). Tracing is telemetry;
    it must never alter job-plane outcomes.
    """
    try:
        await fn()
    except Exception:  # noqa: BLE001 — observability never fails the job
        log.warning("trace write failed (%s); span dropped", label,
                    exc_info=True)


def retry_backoff_s(attempt: int, *, base: float | None = None,
                    cap: float | None = None) -> float:
    """Delay before attempt ``attempt``'s failure becomes claimable again.

    Jittered exponential, the db/retry.py idiom at job scale:
    ``min(base * 2^(attempt-1), cap)`` scaled by ``0.5 + random()`` so a
    herd of same-attempt failures desynchronizes instead of thundering
    back together. ``base == 0`` disables backoff.
    """
    base = config.RETRY_BACKOFF_BASE_S if base is None else base
    cap = config.RETRY_BACKOFF_CAP_S if cap is None else cap
    if base <= 0:
        return 0.0
    delay = min(base * (2 ** max(attempt - 1, 0)), cap)
    return delay * (0.5 + random.random())


async def _record_failure(x: Any, job_id: int, attempt: int,
                          worker: str | None, error: str,
                          failure_class: FailureClass, t: float) -> None:
    """Append one job_failures row (``x`` is a Database or Transaction)."""
    await x.execute(
        """
        INSERT INTO job_failures (job_id, attempt, worker, error,
                                  failure_class, created_at)
        VALUES (:j, :a, :w, :e, :c, :t)
        """,
        {"j": job_id, "a": attempt, "w": worker, "e": error[:2000],
         "c": failure_class.value, "t": t},
    )


async def _dead_letter_crashed(x: Any, job_id: int, video_id: int,
                               kind: str, t: float) -> None:
    """Terminally fail a job whose final attempt's worker crashed, and
    flip its video to failed for transcodes — shared by the expired-claim
    sweep and crash-recovery release so the two paths cannot diverge.
    (``x`` is a Database or Transaction.)"""
    await x.execute(
        """
        UPDATE jobs SET failed_at=:t, next_retry_at=NULL,
               error=COALESCE(error, 'worker crashed on final attempt'),
               updated_at=:t
        WHERE id=:id AND completed_at IS NULL AND failed_at IS NULL
        """,
        {"t": t, "id": job_id},
    )
    if kind == JobKind.TRANSCODE.value:
        # same terminal transition every other dead-letter path takes
        # (daemon._fail / worker_api.fail): the catalog must not show the
        # video processing forever with no job left to advance it
        await x.execute(
            """
            UPDATE videos SET status='failed',
                   error='worker crashed on final transcode attempt',
                   updated_at=:t
            WHERE id=:v AND status NOT IN ('deleted','ready')
            """,
            {"t": t, "v": video_id},
        )


async def get_failure_history(db: Database, job_id: int) -> list[Row]:
    """Per-attempt failure records, oldest first (dead-letter view)."""
    return await db.fetch_all(
        "SELECT * FROM job_failures WHERE job_id=:j ORDER BY id",
        {"j": job_id},
    )


async def enqueue_job(
    db: Database,
    video_id: int,
    kind: JobKind = JobKind.TRANSCODE,
    *,
    priority: int = 0,
    payload: dict[str, Any] | None = None,
    max_attempts: int | None = None,
    required_accelerator: AcceleratorKind | None = None,
    force: bool = False,
    tenant: str = qos.DEFAULT_TENANT,
    deadline_at: float | None = None,
    admit: bool = True,
) -> int:
    """Create (or reset) the job for a video+kind.

    Reference parity: admin.py:719-832 ``create_or_reset_transcoding_job`` —
    an upsert that resets a terminal/stale job back to claimable. Resetting a
    job another worker is actively transcoding raises :class:`JobStateError`
    unless ``force=True`` (the admin "retranscode anyway" path) — otherwise
    two workers could write the same output tree concurrently.

    Tenancy: the job lands in ``tenant`` (default tenant when unnamed)
    and, with ``admit=True``, passes per-tenant admission control first
    (:func:`vlog_tpu_torch.jobs.qos.admit_enqueue` — queue-depth caps and
    brownout shedding raise :class:`~vlog_tpu_torch.jobs.qos.AdmissionError`,
    which HTTP layers map to 429 + Retry-After). Internal follow-up
    enqueues (jobs/finalize.py sprite/transcription) pass
    ``admit=False`` with the parent job's tenant: the tenant already
    paid admission for the pipeline when the root job entered.
    ``deadline_at`` (absolute epoch seconds) opts the job into the
    claim query's deadline-aware boost. Transient DB faults on this
    path feed the enqueue-side brownout breaker (jobs/qos.py), whose
    open state is what triggers shed-low-weight-tenants-first.
    """
    tenant = qos.normalize_tenant(tenant)
    if admit:
        # outside the transaction below: admission counts go through the
        # database facade, whose lock the transaction holds
        await qos.admit_enqueue(db, tenant)
    # pre-transaction: a QoS-relevant enqueue must invalidate the cached
    # claim plan before any claimant can observe the new row
    qos.note_enqueue(db, tenant, deadline_at)
    t = db_now()
    try:
        jid = await _enqueue_txn(
            db, video_id, kind, priority=priority, payload=payload,
            max_attempts=max_attempts,
            required_accelerator=required_accelerator, force=force,
            tenant=tenant, deadline_at=deadline_at, t=t)
    except (ConnectionError, sqlite3.OperationalError) as exc:
        qos.record_enqueue_error(exc)
        raise
    qos.record_enqueue_ok()
    if config.TRACE_ENABLED:
        # root span post-commit: the trace id every later hop joins
        await _trace_write(
            "enqueue", lambda: obs_store.ensure_root(db, jid, created_at=t))
    # after commit, so a woken claimant always sees the row
    _wake(db, CH_JOBS, {"job_id": jid, "kind": kind.value})
    return jid


async def _enqueue_txn(
    db: Database, video_id: int, kind: JobKind, *, priority: int,
    payload: dict[str, Any] | None, max_attempts: int | None,
    required_accelerator: AcceleratorKind | None, force: bool,
    tenant: str, deadline_at: float | None, t: float,
) -> int:
    """The enqueue upsert transaction (see :func:`enqueue_job`)."""
    async with db.transaction() as tx:
        existing = await tx.fetch_one(
            "SELECT * FROM jobs WHERE video_id=:v AND kind=:k",
            {"v": video_id, "k": kind.value},
        )
        params = {
            "p": priority,
            "pl": json.dumps(payload or {}),
            "ma": max_attempts or config.MAX_JOB_ATTEMPTS,
            "ra": required_accelerator.value if required_accelerator else None,
            "tn": tenant,
            "dl": deadline_at,
            "t": t,
        }
        if existing is None:
            jid = await tx.execute(
                """
                INSERT INTO jobs (video_id, kind, priority, payload, max_attempts,
                                  required_accelerator, tenant, deadline_at,
                                  created_at, updated_at)
                VALUES (:v, :k, :p, :pl, :ma, :ra, :tn, :dl, :t, :t)
                """,
                {**params, "v": video_id, "k": kind.value},
            )
        else:
            if (not force
                    and js.derive_state(existing, now=t) is js.JobState.CLAIMED):
                raise js.JobStateError(
                    f"job {existing['id']} is actively claimed by "
                    f"{existing['claimed_by']!r}; pass force=True to reset anyway"
                )
            # Reset: clear claim + terminal markers + progress, keep id stable.
            await tx.execute(
                """
                UPDATE jobs SET priority=:p, payload=:pl, max_attempts=:ma,
                    required_accelerator=:ra, tenant=:tn, deadline_at=:dl,
                    claimed_by=NULL, claimed_at=NULL,
                    claim_expires_at=NULL, started_at=NULL, completed_at=NULL,
                    failed_at=NULL, error=NULL, attempt=0, current_step=NULL,
                    last_checkpoint='{}', progress=0.0, next_retry_at=NULL,
                    updated_at=:t
                WHERE id=:id
                """,
                {**params, "id": existing["id"]},
            )
            await tx.execute(
                "DELETE FROM quality_progress WHERE job_id=:id",
                {"id": existing["id"]},
            )
            # A reset starts a fresh life for the row; the previous life's
            # failure post-mortem would misattribute in the dead-letter view.
            await tx.execute(
                "DELETE FROM job_failures WHERE job_id=:id",
                {"id": existing["id"]},
            )
            # fresh life -> fresh trace (same rule as job_failures)
            await tx.execute(
                "DELETE FROM job_spans WHERE job_id=:id",
                {"id": existing["id"]},
            )
            jid = int(existing["id"])
    return jid


async def _sweep_expired(x: Any, t: float,
                         lock_suffix: str = "") -> tuple[int, list[int]]:
    """Release lapsed leases, attributing each to ``worker_crash``.

    ``x`` is a Database or Transaction; ``lock_suffix`` is the owning
    database's ``row_lock_suffix`` — on Postgres the expired-row select
    takes ``FOR UPDATE SKIP LOCKED`` so two concurrent sweeps cannot
    both attribute the same lapsed lease (sqlite is serialized by
    BEGIN IMMEDIATE). A lapsed lease means the holder neither completed,
    failed, nor renewed — the worker is presumed dead, and the
    job_failures row is the only record the attempt ever existed
    (nothing else writes on this path).

    A swept job whose retry budget is already spent is dead-lettered here
    (its video marked failed for transcodes): releasing it would strand
    it forever — unclaimable (``attempt >= max_attempts`` fails the claim
    filter) yet never terminal, invisible to both the queue and the
    dead-letter view. Returns ``(released, dead_lettered_job_ids)``; the
    caller emits the terminal progress events after its commit.
    """
    expired = await x.fetch_all(
        "SELECT id, video_id, kind, attempt, max_attempts, claimed_by "
        f"FROM jobs WHERE {js.SQL_EXPIRED_CLAIM}{lock_suffix}",
        {"now": t},
    )
    if not expired:
        return 0, []
    for r in expired:
        await _record_failure(
            x, r["id"], r["attempt"] or 0, r["claimed_by"],
            "claim lease expired without completion (worker presumed crashed)",
            FailureClass.WORKER_CRASH, t)
    # Release exactly the rows selected (and, on Postgres, locked) above.
    # Re-running the expired predicate here would block on rows a
    # concurrent sweep's SKIP LOCKED just told us to stay away from.
    marks = ",".join(f":s{i}" for i in range(len(expired)))
    await x.execute(
        f"""
        UPDATE jobs SET claimed_by=NULL, claimed_at=NULL,
               claim_expires_at=NULL, updated_at=:now
        WHERE id IN ({marks})
        """,
        {"now": t, **{f"s{i}": r["id"] for i, r in enumerate(expired)}})
    dead: list[int] = []
    for r in expired:
        if (r["attempt"] or 0) >= (r["max_attempts"] or 1):
            await _dead_letter_crashed(x, r["id"], r["video_id"],
                                       r["kind"], t)
            dead.append(r["id"])
    return len(expired), dead


async def sweep_expired_claims(db: Database) -> int:
    """Release lapsed leases so their jobs become claimable again.

    Reference parity: worker_api.py:1469-1491 (expired-claim sweep inside the
    claim transaction). Each release increments nothing — the attempt counter
    belongs to claim time. No backoff either: the lease interval already
    paced this attempt. Each swept job gains a ``worker_crash`` failure row;
    budget-exhausted jobs are dead-lettered (see _sweep_expired).
    """
    async with db.transaction() as tx:
        released, dead = await _sweep_expired(tx, db_now(),
                                              db.row_lock_suffix)
    for jid in dead:
        _wake(db, CH_PROGRESS, {"job_id": jid, "event": "failed"})
    return released


async def _sweep_if_due(tx: Any, db: Database, t: float) -> list[int]:
    """Oldest-expiry fast-path gating the in-claim sweep.

    The full sweep (row locks, failure rows, dead-lettering) used to run
    inside EVERY claim transaction, so a fleet of claimants serialized
    on redundant sweeps. Now one cheap lock-free aggregate decides: only
    when the oldest live lease has actually lapsed does this claim pay
    for the sweep (keeping the long-standing guarantee that an expired
    lease is reclaimable by the very next claim); otherwise reclamation
    belongs to the periodic :func:`sweep_loop`. Returns the dead-lettered
    job ids (the caller announces them post-commit).
    """
    probe = await tx.fetch_one(
        """
        SELECT MIN(claim_expires_at) AS exp FROM jobs
        WHERE completed_at IS NULL AND failed_at IS NULL
          AND claimed_by IS NOT NULL AND claim_expires_at IS NOT NULL
        """)
    if probe is None or probe["exp"] is None or probe["exp"] > t:
        return []
    _, dead = await _sweep_expired(tx, t, db.row_lock_suffix)
    return dead


async def _qos_candidates(
    tx: Any, base_filter: str, base_params: dict[str, Any],
    policies: dict[str, qos.TenantPolicy], n: int, t: float,
) -> list[Row]:
    """Weighted fair-share candidate pick across tenants (one query).

    Three tiers, in order:

    - **tier 0 — starved**: any claimable job older than
      ``VLOG_QOS_STARVATION_S``, oldest first. The hard liveness bound:
      past it, age beats every weight and priority in the system.
    - **tier 1 — deadline-urgent**: jobs whose ``deadline_at`` falls
      inside the tenant's deadline budget window, earliest deadline
      first.
    - **tier 2 — weighted fair share**: per-tenant rank (priority DESC,
      FIFO — the intact intra-tenant order) plus the tenant's recently
      served count (claims inside ``VLOG_QOS_WAIT_WINDOW_S``), divided
      by the tenant's weight — a weighted-fair-queueing virtual finish
      time whose deficit state lives in the jobs table itself. The
      served term is what makes SINGLE claims round-robin: without it,
      equal-weight tenants all tie at rank 1 and the tie-break would
      drain tenants in global FIFO order. The window keeps the deficit
      from becoming lifetime bookkeeping — a new tenant is not owed the
      whole history of an old one. Equal-weight tenants interleave; a
      weight-2 tenant is offered two jobs per weight-1 job.

    Per-tenant in-flight caps are enforced in the same query: a
    tenant's candidates past its remaining headroom (cap minus
    currently-claimed) are excluded outright, which also caps what a
    single batch can take from that tenant.
    """
    names = sorted(policies)
    inflight: dict[str, int] = {}
    if any(p.max_inflight > 0 for p in policies.values()):
        irows = await tx.fetch_all(
            f"SELECT tenant, COUNT(*) AS n FROM jobs "
            f"WHERE {js.SQL_ACTIVELY_CLAIMED} GROUP BY tenant",
            {"now": t})
        inflight = {r["tenant"]: int(r["n"] or 0) for r in irows}
    srows = await tx.fetch_all(
        "SELECT tenant, COUNT(*) AS n FROM jobs "
        "WHERE claimed_at IS NOT NULL AND claimed_at > :cut "
        "GROUP BY tenant",
        {"cut": t - config.QOS_WAIT_WINDOW_S})
    served = {r["tenant"]: int(r["n"] or 0) for r in srows}

    def _case(col: str, mark: str) -> str:
        whens = " ".join(f"WHEN :qt{i} THEN :{mark}{i}"
                         for i in range(len(names)))
        return f"CASE {col} {whens} ELSE :{mark}d END"

    params = dict(base_params)
    params["lim"] = n
    params["starve"] = t - config.QOS_STARVATION_S
    for i, nm in enumerate(names):
        pol = policies[nm]
        params[f"qt{i}"] = nm
        params[f"qw{i}"] = pol.weight
        params[f"qb{i}"] = pol.deadline_budget_s
        params[f"qh{i}"] = (qos.UNLIMITED if pol.max_inflight == 0
                            else max(0, pol.max_inflight
                                     - inflight.get(nm, 0)))
        params[f"qs{i}"] = served.get(nm, 0)
    # unknown tenants (enqueued after the plan probe) inherit defaults
    params["qwd"] = config.QOS_DEFAULT_WEIGHT
    params["qbd"] = config.QOS_DEADLINE_BUDGET_S
    params["qhd"] = qos.UNLIMITED
    params["qsd"] = 0
    return await tx.fetch_all(
        f"""
        SELECT q.*, ((q.qos_rank + {_case('q.tenant', 'qs')}) * 1.0)
                    / {_case('q.tenant', 'qw')} AS qos_vf
        FROM (
            SELECT j.*,
                   CASE WHEN j.created_at <= :starve THEN 0
                        WHEN j.deadline_at IS NOT NULL
                             AND j.deadline_at <= :now
                                 + {_case('j.tenant', 'qb')} THEN 1
                        ELSE 2 END AS qos_tier,
                   ROW_NUMBER() OVER (
                       PARTITION BY j.tenant
                       ORDER BY j.priority DESC, j.created_at ASC, j.id ASC
                   ) AS qos_rank
            FROM jobs j
            WHERE {base_filter}
        ) q
        WHERE q.qos_rank <= {_case('q.tenant', 'qh')}
        ORDER BY q.qos_tier ASC,
                 CASE WHEN q.qos_tier = 0 THEN q.created_at END ASC,
                 CASE WHEN q.qos_tier = 1 THEN q.deadline_at END ASC,
                 qos_vf ASC, q.priority DESC, q.created_at ASC, q.id ASC
        LIMIT :lim
        """,
        params)


async def claim_jobs(
    db: Database,
    worker_name: str,
    *,
    kinds: tuple[JobKind, ...] = (JobKind.TRANSCODE,),
    accelerator: AcceleratorKind = AcceleratorKind.CPU,
    code_version: str = config.CODE_VERSION,
    lease_s: float | None = None,
    max_jobs: int = 1,
) -> list[Row]:
    """Atomically claim up to ``max_jobs`` eligible jobs in ONE transaction.

    Ordering WITHIN a tenant: priority DESC, then oldest first —
    matching the reference's priority streams + FIFO recovery — and
    identical to issuing ``max_jobs`` single claims back to back (the
    batch walks the same ordered candidate list the single-claim loop
    would). ACROSS tenants the candidate pick is weighted
    deficit-round-robin with a hard starvation bound and a
    deadline-urgency boost (:func:`_qos_candidates`); when only the
    default tenant has claimable work (and it carries no deadline jobs
    or in-flight cap) the pick collapses to the legacy single-ORDER-BY
    query, so single-tenant deployments keep the pre-QoS plan and
    cost. Jobs demanding a specific accelerator
    (``required_accelerator``) are only handed to matching workers;
    jobs demanding a newer code version are skipped
    (worker_api.py:1398-1434). ``max_jobs`` is capped at
    ``VLOG_CLAIM_BATCH_MAX``; each returned row carries its own attempt
    number (the epoch fencing token) and its own post-commit trace
    anchors, exactly as single claims do. The claim request carries no
    tenant logic — fairness is decided entirely server-side, here.
    """
    try:
        # chaos hook for the coordination-plane brownout: an armed
        # db.claim surfaces as the connection fault a flapping Postgres
        # produces, so the worker loops' backoff/breaker path is
        # drivable from VLOG_FAILPOINTS
        failpoints.hit("db.claim")
    except failpoints.FailpointError as exc:
        raise ConnectionError(
            "claim query unavailable (injected db.claim)") from exc
    t = db_now()
    lease = lease_s if lease_s is not None else config.CLAIM_LEASE_S
    n = max(1, min(int(max_jobs), config.CLAIM_BATCH_MAX))
    kind_marks = ",".join(f":k{i}" for i in range(len(kinds)))
    kind_params = {f"k{i}": k.value for i, k in enumerate(kinds)}
    base_filter = f"""{js.SQL_CLAIMABLE}
              AND kind IN ({kind_marks})
              AND attempt < max_attempts
              AND (required_accelerator IS NULL OR required_accelerator = :accel)
              AND (min_code_version IS NULL OR min_code_version <= :cv)"""
    base_params = {"now": t, "accel": accelerator.value,
                   "cv": code_version, **kind_params}
    # tenant discovery + policy resolution, pre-transaction and cached
    # per-db with a short TTL (see qos.claim_plan). A tenant that
    # enqueues between this probe and the claim transaction is picked
    # up within the cache TTL — fairness is a steady-state property,
    # not a per-transaction invariant.
    policies = await qos.claim_plan(db, base_filter, base_params)
    pairs: list[tuple[Row, Row]] = []   # (pre-claim row, claimed row)
    async with db.transaction() as tx:
        # expired leases only swept when the oldest one has lapsed
        dead = await _sweep_if_due(tx, db, t)
        if policies is None:
            # Single-tenant fast path. On Postgres the suffix is FOR
            # UPDATE SKIP LOCKED: concurrent claimants contend on row
            # locks and skip each other's picks — the reference's exact
            # mechanism (worker_api.py:1494-1556). On sqlite it is
            # empty (BEGIN IMMEDIATE already serializes).
            rows = await tx.fetch_all(
                f"""
                SELECT * FROM jobs
                WHERE {base_filter}
                ORDER BY priority DESC, created_at ASC
                LIMIT :lim{db.row_lock_suffix}
                """,
                {**base_params, "lim": n},
            )
        else:
            rows = await _qos_candidates(tx, base_filter, base_params,
                                         policies, n, t)
            if rows and db.row_lock_suffix:
                # The ranked pick cannot carry FOR UPDATE (window
                # functions); lock the picked rows in a second select
                # and keep only the ones still claimable — SKIP LOCKED
                # drops rows a concurrent claimant holds.
                marks = ",".join(f":c{i}" for i in range(len(rows)))
                locked = await tx.fetch_all(
                    f"SELECT * FROM jobs WHERE id IN ({marks})"
                    f"{db.row_lock_suffix}",
                    {f"c{i}": r["id"] for i, r in enumerate(rows)})
                by_id = {r["id"]: r for r in locked}
                rows = [by_id[r["id"]] for r in rows
                        if r["id"] in by_id
                        and js.is_claimable(by_id[r["id"]], now=t)]
        for row in rows:
            js.guard_claim(row, now=t)
            failpoints.hit("claims.claim")
            await tx.execute(
                """
                UPDATE jobs SET claimed_by=:w, claimed_at=:t, claim_expires_at=:exp,
                       started_at=COALESCE(started_at, :t), attempt=attempt+1,
                       next_retry_at=NULL, updated_at=:t
                WHERE id=:id
                """,
                {"w": worker_name, "t": t, "exp": t + lease, "id": row["id"]},
            )
            claimed = await tx.fetch_one("SELECT * FROM jobs WHERE id=:id",
                                         {"id": row["id"]})
            assert claimed is not None
            pairs.append((row, claimed))
    # terminal transitions the sweep performed, announced post-commit
    for jid in dead:
        _wake(db, CH_PROGRESS, {"job_id": jid, "event": "failed"})
    for row, claimed in pairs:
        wait_start = row["updated_at"] or row["created_at"] or t
        obs_runtime().tenant_claim_wait.labels(
            claimed["tenant"]).observe(max(0.0, t - wait_start))
    if pairs and config.TRACE_ENABLED:
        # Trace anchors, post-commit (span writes must never grow the
        # fleet's contention-point transaction, nor fail it — the
        # claims are already committed, and a raising write here would
        # make with_retries claim a SECOND batch): per job, the queue
        # wait since the last state change and the claim event itself.
        async def _claim_spans() -> None:
            for row, claimed in pairs:
                trace_id, root, _ = await obs_store.ensure_root(
                    db, claimed["id"], created_at=claimed["created_at"])
                # stash for the HTTP claim handler so it can hand the
                # worker the trace context without re-reading the root
                # row (rows are plain dicts; serializing callers pop it)
                claimed["_trace"] = {"trace_id": trace_id,
                                     "parent_span_id": root}
                wait_start = row["updated_at"] or row["created_at"] or t
                await obs_store.record(
                    db, claimed["id"], trace_id=trace_id, parent_id=root,
                    name="queue.wait", started_at=wait_start,
                    duration_s=max(0.0, t - wait_start),
                    attrs={"attempt": claimed["attempt"],
                           "tenant": claimed["tenant"]})
                await obs_store.record(
                    db, claimed["id"], trace_id=trace_id, parent_id=root,
                    name="server.claim", started_at=t,
                    duration_s=max(0.0, db_now() - t),
                    attrs={"worker": worker_name, "kind": claimed["kind"],
                           "attempt": claimed["attempt"],
                           "tenant": claimed["tenant"]})

        await _trace_write("claim", _claim_spans)
    return [claimed for _, claimed in pairs]


async def claim_job(
    db: Database,
    worker_name: str,
    *,
    kinds: tuple[JobKind, ...] = (JobKind.TRANSCODE,),
    accelerator: AcceleratorKind = AcceleratorKind.CPU,
    code_version: str = config.CODE_VERSION,
    lease_s: float | None = None,
) -> Row | None:
    """Atomically claim the best eligible job, or return None.

    Single-job façade over :func:`claim_jobs` — same ordering, fencing,
    and trace anchors with ``max_jobs=1``.
    """
    rows = await claim_jobs(
        db, worker_name, kinds=kinds, accelerator=accelerator,
        code_version=code_version, lease_s=lease_s, max_jobs=1)
    return rows[0] if rows else None


async def sweep_loop(db: Database, stop: asyncio.Event, *,
                     interval_s: float | None = None) -> None:
    """Jittered per-process periodic expired-lease sweeper.

    With the per-claim sweep reduced to an oldest-expiry probe
    (:func:`_sweep_if_due`), this loop is what guarantees lapsed leases
    are released and dead-lettered even when nobody is claiming. The
    interval is jittered ±50% (the retry_backoff_s idiom) so a fleet of
    API/daemon processes desynchronizes instead of sweeping in lockstep.
    Exits when ``stop`` is set; a failing sweep (DB brownout) is logged
    and retried next tick — the sweeper must outlive transient faults.
    """
    base = config.SWEEP_INTERVAL_S if interval_s is None else interval_s
    if base <= 0:
        return
    while not stop.is_set():
        delay = base * (0.5 + random.random())
        try:
            await asyncio.wait_for(stop.wait(), delay)
            return
        except asyncio.TimeoutError:
            pass
        try:
            await sweep_expired_claims(db)
        except Exception:  # noqa: BLE001 — the sweeper outlives brownouts
            log.warning("periodic lease sweep failed; retrying next tick",
                        exc_info=True)


async def update_progress(
    db: Database,
    job_id: int,
    worker_name: str,
    *,
    progress: float | None = None,
    current_step: str | None = None,
    checkpoint: dict[str, Any] | None = None,
    extend_lease: bool = True,
    epoch: int | None = None,
) -> Row:
    """Record progress and extend the claim lease.

    Reference parity: worker_api.py:1747-1860 — every progress update renews
    the lease, which is what keeps long jobs alive past the base lease.
    Raises :class:`JobStateError` if the caller no longer holds the claim
    (the 409-abort signal remote workers act on) or ``epoch`` (the
    claim's attempt number, the fencing token) is stale.

    ``checkpoint`` is stored verbatim as JSON under ``jobs.last_checkpoint``;
    its shape is owned by the job kind. Transcription stores
    ``{"asr": {"windows": {index: 1}, "language": ...}}`` — the set of
    decoded window indices plus the detected language — which the ASR
    engine (asr/engine.py) reads on resume to re-submit only the windows
    the preempted attempt never finished.
    """
    t = db_now()
    async with db.transaction() as tx:
        row = await tx.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id})
        if row is None:
            raise js.JobStateError(f"job {job_id} does not exist")
        js.guard_epoch(row, epoch)
        js.guard_progress(row, worker_name, now=t)
        sets = ["updated_at=:t"]
        params: dict[str, Any] = {"t": t, "id": job_id}
        if progress is not None:
            sets.append("progress=:p")
            params["p"] = max(0.0, min(100.0, progress))
        if current_step is not None:
            sets.append("current_step=:s")
            params["s"] = current_step
        if checkpoint is not None:
            sets.append("last_checkpoint=:c")
            params["c"] = json.dumps(checkpoint)
        if extend_lease:
            sets.append("claim_expires_at=:exp")
            params["exp"] = t + config.CLAIM_LEASE_S
        await tx.execute(f"UPDATE jobs SET {', '.join(sets)} WHERE id=:id", params)
        out = await tx.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id})
        assert out is not None
    _wake(db, CH_PROGRESS, {"job_id": job_id, "event": "progress",
                            "progress": out["progress"],
                            "step": out["current_step"]})
    return out


async def complete_job(db: Database, job_id: int, worker_name: str, *,
                       epoch: int | None = None) -> Row:
    """Mark a job completed (terminal). Reference: worker_api.py:1864-2070."""
    t = db_now()
    async with db.transaction() as tx:
        row = await tx.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id})
        if row is None:
            raise js.JobStateError(f"job {job_id} does not exist")
        js.guard_epoch(row, epoch)
        js.guard_complete(row, worker_name, now=t)
        failpoints.hit("claims.complete")
        await tx.execute(
            """
            UPDATE jobs SET completed_at=:t, progress=100.0, claimed_by=NULL,
                   claim_expires_at=NULL, error=NULL, updated_at=:t
            WHERE id=:id
            """,
            {"t": t, "id": job_id},
        )
        out = await tx.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id})
        assert out is not None
    if config.TRACE_ENABLED:
        async def _complete_spans() -> None:
            trace_id, root, _ = await obs_store.ensure_root(
                db, job_id, created_at=out["created_at"])
            await obs_store.close_root(db, job_id, t)
            await obs_store.record(
                db, job_id, trace_id=trace_id, parent_id=root,
                name="job.complete", started_at=t, duration_s=0.0,
                attrs={"worker": worker_name})

        await _trace_write("complete", _complete_spans)
    _wake(db, CH_PROGRESS, {"job_id": job_id, "event": "completed"})
    return out


async def fail_job(
    db: Database,
    job_id: int,
    worker_name: str | None,
    error: str,
    *,
    permanent: bool = False,
    failure_class: FailureClass | str | None = None,
    epoch: int | None = None,
) -> Row:
    """Record a failed attempt; terminal only when the retry budget is gone.

    Reference parity: worker_api.py:2074-2190 + transcoder.py:2869-2933 —
    a failure releases the claim; the job terminally fails when
    ``attempt >= max_attempts`` (or ``permanent=True``), otherwise it is
    stamped with jittered exponential backoff (``next_retry_at``) and
    derives BACKOFF until due. Every call appends a classified
    ``job_failures`` row; ``failure_class`` defaults to PERMANENT when
    ``permanent`` else TRANSIENT.

    ``DEVICE_FAULT`` and ``PREEMPTED`` are the innocent-job classes: the
    accelerator (not the input, not the code) failed the attempt, or the
    HOST was evicted mid-attempt (drain grace lapsed) — so the attempt
    counter is REFUNDED and no backoff is stamped. The job goes straight
    back to the claimable pool: for device faults the faulting worker's
    quarantined devices keep it off the same sick hardware; for
    preemptions the evicting worker has stopped claiming, so a healthy
    successor resumes the uploaded partial tree.

    Each refund class is BOUNDED at ``max_attempts`` attributions per
    job life: a failure that looks innocent every single time (a ladder
    that deterministically OOMs HBM; a job that somehow rides only
    doomed hosts) is the job's problem after all — past the bound it
    burns budget like any transient, so it dead-letters instead of
    livelocking through endless refund cycles.
    """
    if failure_class is None:
        failure_class = (FailureClass.PERMANENT if permanent
                         else FailureClass.TRANSIENT)
    else:
        failure_class = FailureClass(failure_class)
    refund = (failure_class in (FailureClass.DEVICE_FAULT,
                                FailureClass.PREEMPTED)
              and not permanent)
    t = db_now()
    async with db.transaction() as tx:
        row = await tx.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id})
        if row is None:
            raise js.JobStateError(f"job {job_id} does not exist")
        js.guard_epoch(row, epoch)
        js.guard_fail(row, worker_name, now=t)
        failpoints.hit("claims.fail")
        if refund:
            prior = await tx.fetch_one(
                "SELECT COUNT(*) AS n FROM job_failures "
                "WHERE job_id=:j AND failure_class=:c",
                {"j": job_id, "c": failure_class.value})
            if (prior["n"] or 0) >= (row["max_attempts"] or 1):
                # refund bound reached: this "innocent" failure follows
                # the job everywhere — charge the job from here on
                refund = False
        exhausted = permanent or (
            not refund
            and (row["attempt"] or 0) >= (row["max_attempts"] or 1))
        retry_at = None if (exhausted or refund) \
            else t + retry_backoff_s(row["attempt"] or 1)
        attempt_sql = (f"attempt={db.greatest('attempt - 1', '0')},"
                       if refund else "")
        await tx.execute(
            f"""
            UPDATE jobs SET claimed_by=NULL, claimed_at=NULL, claim_expires_at=NULL,
                   {attempt_sql} failed_at=:failed_at, error=:err,
                   next_retry_at=:nra, updated_at=:t
            WHERE id=:id
            """,
            {
                "failed_at": t if exhausted else None,
                "err": error[:2000],
                "nra": retry_at,
                "t": t,
                "id": job_id,
            },
        )
        await _record_failure(tx, job_id, row["attempt"] or 0, worker_name,
                              error, failure_class, t)
        out = await tx.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id})
        assert out is not None
    if not exhausted:
        obs_runtime().job_backoff.inc()
    if config.TRACE_ENABLED:
        async def _fail_spans() -> None:
            trace_id, root, _ = await obs_store.ensure_root(
                db, job_id, created_at=out["created_at"])
            if exhausted:
                await obs_store.close_root(db, job_id, t)
            await obs_store.record(
                db, job_id, trace_id=trace_id, parent_id=root,
                name="job.fail", started_at=t, duration_s=0.0,
                status="error",
                attrs={"worker": worker_name, "error": error[:300],
                       "failure_class": failure_class.value,
                       "terminal": exhausted,
                       "attempt": row["attempt"] or 0})

        await _trace_write("fail", _fail_spans)
    _wake(db, CH_PROGRESS, {"job_id": job_id,
                            "event": "failed" if exhausted else "retrying"})
    if not exhausted:
        # back in the claimable pool (once the backoff lapses) — wake
        # sleeping workers; their claim query enforces next_retry_at
        _wake(db, CH_JOBS, {"job_id": job_id})
    return out


async def release_job(
    db: Database, job_id: int, worker_name: str, *,
    refund_attempt: bool = True, epoch: int | None = None
) -> Row:
    """Hand an in-flight claim back to the pool.

    This is the graceful-shutdown path (reference transcoder.py:3227-3276:
    SIGTERM resets in-flight work to pending so another worker picks it up
    immediately). With ``refund_attempt`` the attempt counter is rolled back
    — the work was interrupted, not attempted-and-failed. Crash-recovery
    callers (a restarted worker releasing its dead incarnation's claims)
    must pass ``refund_attempt=False``: a job that kills its worker process
    would otherwise never exhaust ``max_attempts``. The no-refund path also
    records a ``worker_crash`` failure row and applies retry backoff — a
    poison job under a fast supervisor restart loop must not burn its
    whole budget at relaunch speed — and, when the budget is already
    spent, dead-letters the job outright (same strand-avoidance rule as
    the expired-claim sweep: a released final attempt would be
    unclaimable yet never terminal).
    """
    t = db_now()
    async with db.transaction() as tx:
        row = await tx.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id})
        if row is None:
            raise js.JobStateError(f"job {job_id} does not exist")
        js.guard_epoch(row, epoch)
        # Same ownership rule as progress: only the claim holder may release.
        js.guard_progress(row, worker_name, now=t)
        exhausted = (not refund_attempt
                     and (row["attempt"] or 0) >= (row["max_attempts"] or 1))
        attempt_sql = (f"attempt={db.greatest('attempt - 1', '0')},"
                       if refund_attempt else "")
        retry_at = None if (refund_attempt or exhausted) \
            else t + retry_backoff_s(row["attempt"] or 1)
        await tx.execute(
            f"""
            UPDATE jobs SET claimed_by=NULL, claimed_at=NULL, claim_expires_at=NULL,
                   {attempt_sql} next_retry_at=:nra, updated_at=:t
            WHERE id=:id
            """,
            {"t": t, "nra": retry_at, "id": job_id},
        )
        if not refund_attempt:
            await _record_failure(
                tx, job_id, row["attempt"] or 0, worker_name,
                "claim released without refund (previous worker incarnation "
                "crashed mid-job)", FailureClass.WORKER_CRASH, t)
        if exhausted:
            await _dead_letter_crashed(tx, job_id, row["video_id"],
                                       row["kind"], t)
        out = await tx.fetch_one("SELECT * FROM jobs WHERE id=:id", {"id": job_id})
        assert out is not None
    if exhausted:
        _wake(db, CH_PROGRESS, {"job_id": job_id, "event": "failed"})
    else:
        _wake(db, CH_JOBS, {"job_id": job_id})   # claimable again
    return out


async def upsert_quality_progress(
    db: Database,
    job_id: int,
    quality: str,
    *,
    status: str,
    progress: float = 0.0,
) -> None:
    """Per-rung checkpoint row (reference: database.py:209-248)."""
    await db.execute(
        """
        INSERT INTO quality_progress (job_id, quality, status, progress, updated_at)
        VALUES (:j, :q, :s, :p, :t)
        ON CONFLICT (job_id, quality)
        DO UPDATE SET status=:s, progress=:p, updated_at=:t
        """,
        {"j": job_id, "q": quality, "s": status, "p": progress, "t": db_now()},
    )


async def get_quality_progress(db: Database, job_id: int) -> dict[str, Row]:
    rows = await db.fetch_all(
        "SELECT * FROM quality_progress WHERE job_id=:j", {"j": job_id}
    )
    return {r["quality"]: r for r in rows}
