"""Span persistence + tree assembly over the ``job_spans`` table (a copy of
``vlog_tpu/obs/store.py``).

One trace per job life: the root row (``parent_id IS NULL``, name
``job``) is minted at enqueue and deleted with the other per-life rows
(job_failures, quality_progress) when a job is reset/requeued — a fresh
life gets a fresh trace. Everything else parents under it: server-side
claim/complete markers written by jobs/claims.py, the worker's attempt
spans (written directly by the local daemon, shipped over
``POST /api/worker/jobs/{id}/spans`` by remote workers), and the
synthesized ``stage.*`` / ``rung.*`` leaves.

All functions take the caller's Database — this module owns no
connection and imports no HTTP, so every process can use it.
"""

from __future__ import annotations

import json

from vlog_tpu_torch.db.core import Database, now as db_now
from vlog_tpu_torch.obs import trace as obs_trace
from vlog_tpu_torch.obs.trace import Span

ROOT_NAME = "job"
# sanity caps for worker-reported spans (the upload endpoint enforces)
MAX_SPANS_PER_REPORT = 500
MAX_NAME_LEN = 120
MAX_ATTRS_LEN = 4000

# Idempotent on (job_id, span_id): a worker's span report may be
# retried after a lost response, and the duplicate insert must be a
# no-op, not a second copy in the waterfall.
_INSERT_SQL = """
    INSERT INTO job_spans (job_id, trace_id, span_id, parent_id, name,
                           origin, started_at, duration_s, status,
                           attributes, created_at)
    VALUES (:j, :tid, :sid, :pid, :name, :origin, :start, :dur,
            :status, :attrs, :t)
    ON CONFLICT DO NOTHING
"""


def _attrs_blob(attrs: dict | None) -> str:
    try:
        blob = json.dumps(attrs or {})
    except (TypeError, ValueError):
        return json.dumps({"unserializable": True})
    if len(blob) > MAX_ATTRS_LEN:
        # whole-value replacement, never a mid-token cut: a truncated
        # JSON string would fail to parse and silently drop EVERY attr
        return json.dumps({"truncated": True, "attrs_bytes": len(blob)})
    return blob


def _params(job_id: int, trace_id: str, span_id: str,
            parent_id: str | None, name: str, origin: str,
            started_at: float, duration_s: float | None, status: str,
            attrs: dict | None) -> dict:
    return {"j": job_id, "tid": trace_id, "sid": span_id,
            "pid": parent_id, "name": name[:MAX_NAME_LEN],
            "origin": origin, "start": started_at, "dur": duration_s,
            "status": status, "attrs": _attrs_blob(attrs), "t": db_now()}


async def ensure_root(db: Database, job_id: int, *,
                      created_at: float | None = None
                      ) -> tuple[str, str, float]:
    """Return (trace_id, root_span_id, root_started_at), minting the
    root row if the job predates the trace plane.

    Race-safe: two concurrent callers (enqueue's post-commit mint
    racing a fast claimant) both INSERT, but the partial unique index
    (one ``parent_id IS NULL`` row per job) makes the loser's write a
    no-op — both then re-read the one surviving root, so a job can
    never fork into two traces."""
    row = await db.fetch_one(
        "SELECT trace_id, span_id, started_at FROM job_spans "
        "WHERE job_id=:j AND parent_id IS NULL ORDER BY id LIMIT 1",
        {"j": job_id})
    if row is not None:
        return row["trace_id"], row["span_id"], row["started_at"]
    started = created_at if created_at is not None else db_now()
    minted = obs_trace.new_id()
    # count_metric=False: the partial root-unique index may suppress
    # this insert (two concurrent minters), which the (job_id, span_id)
    # dup probe cannot see — bump the counter below, winner only
    await record(db, job_id, trace_id=obs_trace.new_id(),
                 span_id=minted, parent_id=None,
                 name=ROOT_NAME, started_at=started, count_metric=False)
    row = await db.fetch_one(
        "SELECT trace_id, span_id, started_at FROM job_spans "
        "WHERE job_id=:j AND parent_id IS NULL ORDER BY id LIMIT 1",
        {"j": job_id})
    assert row is not None
    if row["span_id"] == minted:
        from vlog_tpu_torch.obs.metrics import runtime

        runtime().spans_recorded.labels("server").inc()
    return row["trace_id"], row["span_id"], row["started_at"]


async def record(db: Database, job_id: int, *, trace_id: str,
                 name: str, started_at: float,
                 span_id: str | None = None, parent_id: str | None = None,
                 duration_s: float | None = None, status: str = "ok",
                 attrs: dict | None = None, origin: str = "server",
                 count_metric: bool = True) -> str:
    """Insert one span row (idempotent, see ``_INSERT_SQL``); returns
    its span id."""
    sid = span_id or obs_trace.new_id()
    # only a caller-supplied id can collide with an existing row (a
    # fresh new_id() is ours alone) — don't pay a dup-probe round-trip
    # on the common path just to keep the spans_recorded counter exact
    dup = span_id is not None and await db.fetch_one(
        "SELECT 1 FROM job_spans WHERE job_id=:j AND span_id=:s",
        {"j": job_id, "s": sid}) is not None
    await db.execute(_INSERT_SQL, _params(job_id, trace_id, sid, parent_id,
                                          name, origin, started_at,
                                          duration_s, status, attrs))
    if not dup and count_metric:
        from vlog_tpu_torch.obs.metrics import runtime

        runtime().spans_recorded.labels(origin).inc()
    return sid


async def record_spans(db: Database, job_id: int, spans: list[Span], *,
                       origin: str = "worker",
                       trace_id: str | None = None) -> list[str]:
    """Bulk-persist finished spans (a drained TraceBuffer); returns the
    span ids actually INSERTED — spans the job already holds (a retried
    report whose first response was lost) are skipped, so callers can
    gate side effects (histogram observation) on genuinely-new spans.

    ``trace_id``, when given, overrides whatever the spans carry — the
    server is authoritative about which trace a job belongs to, so a
    confused (or hostile) worker cannot graft spans onto another job's
    trace. One transaction AND one multi-row insert for the whole batch:
    a large attempt buffer must cost one dedupe read plus one
    ``executemany`` on the shared DB, not a round-trip per span.
    """
    todo = spans[:MAX_SPANS_PER_REPORT]
    if not todo:
        return []
    inserted: list[str] = []
    async with db.transaction() as tx:
        # dedupe read INSIDE the transaction: transactions serialize on
        # the write lock, so a retried report racing its lost-response
        # original sees the original's committed rows — reading before
        # the transaction would let both count the same spans as new
        # (and double-observe the fleet histograms downstream)
        existing = {r["span_id"] for r in await tx.fetch_all(
            "SELECT span_id FROM job_spans WHERE job_id=:j", {"j": job_id})}
        batch: list[dict] = []
        for sp in todo:
            if sp.span_id in existing:
                continue
            batch.append(_params(
                job_id, trace_id or sp.trace_id, sp.span_id, sp.parent_id,
                sp.name, origin, sp.started_at, sp.duration_s,
                sp.status if sp.status in ("ok", "error") else "ok",
                sp.attrs))
            inserted.append(sp.span_id)
            existing.add(sp.span_id)   # dedupe repeats inside one report
        if batch:
            await tx.execute_many(_INSERT_SQL, batch)
    if inserted:
        from vlog_tpu_torch.obs.metrics import runtime

        runtime().spans_recorded.labels(origin).inc(len(inserted))
    return inserted


async def close_root(db: Database, job_id: int, ended_at: float) -> None:
    """Stamp the root span's duration at job completion/terminal failure
    (idempotent; the last terminal transition wins)."""
    await db.execute(
        """
        UPDATE job_spans SET duration_s = :end - started_at
        WHERE job_id=:j AND parent_id IS NULL
        """,
        {"end": ended_at, "j": job_id})


async def fetch_trace(db: Database, job_id: int) -> dict:
    """The ordered span tree for one job: ``{trace_id, spans: [...]}``,
    children nested and sorted by start time."""
    rows = await db.fetch_all(
        "SELECT * FROM job_spans WHERE job_id=:j ORDER BY started_at, id",
        {"j": job_id})
    nodes = []
    for r in rows:
        try:
            attrs = json.loads(r["attributes"] or "{}")
        except ValueError:
            attrs = {}
        nodes.append({
            "span_id": r["span_id"], "parent_id": r["parent_id"],
            "name": r["name"], "origin": r["origin"],
            "started_at": r["started_at"], "duration_s": r["duration_s"],
            "status": r["status"], "attrs": attrs, "children": [],
        })
    return {"trace_id": rows[0]["trace_id"] if rows else None,
            "spans": build_tree(nodes)}


def build_tree(nodes: list[dict]) -> list[dict]:
    """Nest span dicts by parent_id; orphans (parent never reported —
    e.g. a worker crashed before shipping an ancestor) surface as roots
    rather than vanishing. Input order (started_at) is preserved.

    Worker-supplied parent ids are arbitrary strings, so parent cycles
    (A under B under A) are possible; every cycle is broken by promoting
    its earliest node to a root — nothing is ever dropped, and the
    result is always a finite tree."""
    by_id = {n["span_id"]: n for n in nodes}
    roots: list[dict] = []
    for n in nodes:
        parent = by_id.get(n["parent_id"]) if n["parent_id"] else None
        if parent is not None and parent is not n:
            parent["children"].append(n)
        else:
            roots.append(n)
    reachable: set[int] = set()
    stack = list(roots)
    while stack:
        node = stack.pop()
        if id(node) in reachable:
            continue
        reachable.add(id(node))
        stack.extend(node["children"])
    for n in nodes:
        if id(n) in reachable:
            continue
        # unreachable = part of a parent cycle; cut it loose from its
        # parent and surface it (with its whole subtree) as a root
        by_id[n["parent_id"]]["children"].remove(n)
        roots.append(n)
        stack = [n]
        while stack:
            node = stack.pop()
            if id(node) in reachable:
                continue
            reachable.add(id(node))
            stack.extend(node["children"])
    return roots
