"""Pure job state machine (a copy of
``vlog_tpu/jobs/state.py``).

Reference parity: api/job_state.py:48-616 — states *derived* from
nullable columns so the database can never hold a contradictory state, plus
composable SQL fragments and transition guards used by the claim protocol.

Column semantics (see db/schema.py `jobs` table):

- ``completed_at`` set  -> COMPLETED (terminal)
- ``failed_at`` set     -> FAILED (terminal)
- ``claimed_by`` set and lease valid  -> CLAIMED
- ``claimed_by`` set and lease lapsed -> EXPIRED (reclaimable)
- ``claimed_by`` null, attempt > 0, ``next_retry_at`` in the future
                                      -> BACKOFF (not yet claimable)
- ``claimed_by`` null, attempt > 0    -> RETRYING
- ``claimed_by`` null, attempt == 0   -> UNCLAIMED

BACKOFF is the retry-pacing state: ``fail_job`` stamps ``next_retry_at``
with jittered exponential backoff (config: VLOG_RETRY_BACKOFF_BASE /
VLOG_RETRY_BACKOFF_CAP), and ``SQL_CLAIMABLE`` skips rows that are not
yet due, so a crash-looping job cannot burn its whole retry budget in
seconds. Claiming clears the timestamp.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

from vlog_tpu_torch.enums import JobState


class JobStateError(RuntimeError):
    """An illegal transition was attempted (guard failure)."""


def derive_state(row: Mapping[str, Any], *, now: float) -> JobState:
    """Derive the state of a job row at time ``now``."""
    if row.get("completed_at") is not None:
        return JobState.COMPLETED
    if row.get("failed_at") is not None:
        return JobState.FAILED
    if row.get("claimed_by") is not None:
        expires = row.get("claim_expires_at")
        if expires is not None and expires <= now:
            return JobState.EXPIRED
        return JobState.CLAIMED
    if (row.get("attempt") or 0) > 0:
        nra = row.get("next_retry_at")
        if nra is not None and nra > now:
            return JobState.BACKOFF
        return JobState.RETRYING
    return JobState.UNCLAIMED


def is_terminal(state: JobState) -> bool:
    return state in (JobState.COMPLETED, JobState.FAILED)


def is_claimable(row: Mapping[str, Any], *, now: float) -> bool:
    """A job is claimable when unclaimed/retrying or its claim lease lapsed.

    BACKOFF is deliberately absent: a failed attempt is not claimable
    again until its ``next_retry_at`` has passed (it then derives
    RETRYING).
    """
    return derive_state(row, now=now) in (
        JobState.UNCLAIMED,
        JobState.RETRYING,
        JobState.EXPIRED,
    )


# --------------------------------------------------------------------------
# Composable SQL conditions (named-parameter style; caller supplies :now)
# --------------------------------------------------------------------------

SQL_NOT_TERMINAL = "(completed_at IS NULL AND failed_at IS NULL)"

SQL_CLAIMABLE = (
    f"{SQL_NOT_TERMINAL} AND "
    "(claimed_by IS NULL OR (claim_expires_at IS NOT NULL AND claim_expires_at <= :now))"
    " AND (next_retry_at IS NULL OR next_retry_at <= :now)"
)

# Completes the composable-fragment family (one per derivable state with
# a waiting pool); the SQL/Python agreement tests hold it to derive_state,
# and operators use it for ad-hoc "what is the queue waiting on" queries.
SQL_IN_BACKOFF = (
    f"{SQL_NOT_TERMINAL} AND claimed_by IS NULL AND attempt > 0 AND "
    "next_retry_at IS NOT NULL AND next_retry_at > :now"
)

SQL_ACTIVELY_CLAIMED = (
    f"{SQL_NOT_TERMINAL} AND claimed_by IS NOT NULL AND "
    "(claim_expires_at IS NULL OR claim_expires_at > :now)"
)

SQL_EXPIRED_CLAIM = (
    f"{SQL_NOT_TERMINAL} AND claimed_by IS NOT NULL AND "
    "claim_expires_at IS NOT NULL AND claim_expires_at <= :now"
)


def sql_state_case(alias: str = "") -> str:
    """The :func:`derive_state` rules as one SQL CASE expression
    (caller supplies ``:now``). ``alias`` prefixes every column (e.g.
    ``"j."``) for joined queries. One definition serves the admin queue
    browser's per-state counts/filters AND the /metrics job-state
    gauges, so the SQL and Python derivations cannot drift apart."""
    a = alias
    return f"""
    CASE
      WHEN {a}completed_at IS NOT NULL THEN 'completed'
      WHEN {a}failed_at IS NOT NULL THEN 'failed'
      WHEN {a}claimed_by IS NOT NULL AND ({a}claim_expires_at IS NULL
           OR {a}claim_expires_at > :now) THEN 'claimed'
      WHEN {a}claimed_by IS NOT NULL THEN 'expired'
      WHEN {a}attempt > 0 AND {a}next_retry_at IS NOT NULL
           AND {a}next_retry_at > :now THEN 'backoff'
      WHEN {a}attempt > 0 THEN 'retrying'
      ELSE 'unclaimed'
    END
    """


# --------------------------------------------------------------------------
# Transition guards — raise JobStateError on contract violations
# --------------------------------------------------------------------------

def guard_claim(row: Mapping[str, Any], *, now: float) -> None:
    state = derive_state(row, now=now)
    if state not in (JobState.UNCLAIMED, JobState.RETRYING, JobState.EXPIRED):
        raise JobStateError(f"cannot claim job in state {state.value}")
    if (row.get("attempt") or 0) >= (row.get("max_attempts") or 1):
        raise JobStateError("retry budget exhausted")


def guard_epoch(row: Mapping[str, Any], epoch: int | None) -> None:
    """Fencing-token check: the claim's attempt number is its epoch.

    A partitioned worker whose lease was swept and re-claimed — even
    under the SAME worker name, where the ownership guards above cannot
    tell the incarnations apart — carries the old attempt number and
    must not write into the successor attempt's tree or trace. ``None``
    (no ``X-Claim-Epoch`` header) skips the check for pre-fencing
    clients; every call the shipped client makes carries it.
    """
    if epoch is not None and int(epoch) != (row.get("attempt") or 0):
        raise JobStateError(
            f"stale claim epoch {epoch}: job is on attempt "
            f"{row.get('attempt') or 0} (lease was swept and re-claimed)"
        )


def guard_progress(row: Mapping[str, Any], worker: str, *, now: float) -> None:
    state = derive_state(row, now=now)
    if state is not JobState.CLAIMED:
        raise JobStateError(f"progress update on job in state {state.value}")
    if row.get("claimed_by") != worker:
        raise JobStateError(
            f"progress from {worker!r} but job is claimed by {row.get('claimed_by')!r}"
        )


def guard_complete(row: Mapping[str, Any], worker: str, *, now: float) -> None:
    state = derive_state(row, now=now)
    if state is JobState.COMPLETED:
        raise JobStateError("job already completed")
    if state is JobState.FAILED:
        raise JobStateError("job already failed terminally")
    if row.get("claimed_by") != worker:
        raise JobStateError(
            f"completion from {worker!r} but job is claimed by {row.get('claimed_by')!r}"
        )


def guard_fail(row: Mapping[str, Any], worker: str | None, *, now: float) -> None:
    state = derive_state(row, now=now)
    if is_terminal(state):
        raise JobStateError(f"fail on job already in state {state.value}")
    if worker is not None and row.get("claimed_by") not in (None, worker):
        raise JobStateError(
            f"failure from {worker!r} but job is claimed by {row.get('claimed_by')!r}"
        )
