"""Worker command channel: remote management over the shared DB (a copy of
``vlog_tpu/jobs/commands.py``).

Reference parity: worker/command_listener.py:46-449 + the admin-side
pub/sub RPC (api/pubsub.py:446-545, admin.py:5164-5290) — operators send
a worker a command (ping / stats / stop), the worker picks it up on its
next heartbeat tick and writes a response. Redis pub/sub is replaced by
the same DB-as-bus pattern the rest of the job plane uses; latency is
one heartbeat interval, which is what the reference's remote log/metric
fetches effectively had too.
"""

from __future__ import annotations

import json
from typing import Any, Awaitable, Callable

from vlog_tpu_torch.db.core import Database, Row, now as db_now

KNOWN_COMMANDS = ("ping", "stats", "stop", "drain", "get_logs",
                  "get_metrics", "restart", "update")

# async (command, args) -> response dict
CommandFn = Callable[[str, dict], Awaitable[dict]]


async def send_command(db: Database, worker_name: str, command: str,
                       args: dict | None = None) -> int:
    if command not in KNOWN_COMMANDS:
        raise ValueError(f"unknown command {command!r}")
    return await db.execute(
        """
        INSERT INTO worker_commands (worker_name, command, args, created_at)
        VALUES (:w, :c, :a, :t)
        """,
        {"w": worker_name, "c": command, "a": json.dumps(args or {}),
         "t": db_now()})


async def get_command(db: Database, command_id: int) -> Row | None:
    row = await db.fetch_one(
        "SELECT * FROM worker_commands WHERE id=:id", {"id": command_id})
    if row is not None:
        row["args"] = json.loads(row["args"] or "{}")
        row["response"] = (json.loads(row["response"])
                           if row["response"] else None)
    return row


async def list_commands(db: Database, worker_name: str,
                        limit: int = 50) -> list[Row]:
    rows = await db.fetch_all(
        """
        SELECT * FROM worker_commands WHERE worker_name=:w
        ORDER BY id DESC LIMIT :lim
        """, {"w": worker_name, "lim": limit})
    for r in rows:
        r["args"] = json.loads(r["args"] or "{}")
        r["response"] = json.loads(r["response"]) if r["response"] else None
    return rows


async def claim_pending(db: Database, worker_name: str) -> list[Row]:
    """Atomically pick up this worker's unhandled commands."""
    t = db_now()
    async with db.transaction() as tx:
        rows = await tx.fetch_all(
            """
            SELECT * FROM worker_commands
            WHERE worker_name=:w AND picked_up_at IS NULL
            ORDER BY id
            """, {"w": worker_name})
        for r in rows:
            await tx.execute(
                "UPDATE worker_commands SET picked_up_at=:t WHERE id=:id",
                {"t": t, "id": r["id"]})
    for r in rows:
        r["args"] = json.loads(r["args"] or "{}")
    return rows


async def respond(db: Database, command_id: int, response: dict) -> None:
    await db.execute(
        """
        UPDATE worker_commands SET completed_at=:t, response=:r
        WHERE id=:id
        """,
        {"t": db_now(), "r": json.dumps(response), "id": command_id})


async def drain_for_worker(db: Database, worker_name: str,
                           handler: CommandFn) -> int:
    """One poll tick: pick up pending commands, run the handler, write
    responses. Returns commands handled."""
    rows = await claim_pending(db, worker_name)
    for row in rows:
        try:
            resp = await handler(row["command"], row["args"])
        except Exception as exc:  # noqa: BLE001 — respond, don't crash
            resp = {"error": f"{type(exc).__name__}: {exc}"}
        await respond(db, row["id"], resp)
    return len(rows)
