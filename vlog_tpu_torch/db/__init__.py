"""Persistence layer: async database facade + schema (a copy of
``vlog_tpu/db``: the sqlite facade, the Postgres facade over libpq, its
wire-protocol test double, the schema and the retry policy).

Reference parity: api/database.py (SQLAlchemy Core + `databases` pool over
Postgres). Neither is a dependency here: :mod:`.core` is an async facade
over sqlite3 (WAL mode, multi-process safe) and :mod:`.pg` the same API
over the system libpq; :func:`.core.open_database` picks one by URL.
"""

from vlog_tpu_torch.db.core import Database, Transaction
from vlog_tpu_torch.db.schema import create_all, SCHEMA_VERSION

__all__ = ["Database", "Transaction", "create_all", "SCHEMA_VERSION"]
