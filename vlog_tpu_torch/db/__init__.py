"""Persistence layer: async database facade + schema (a copy of
``vlog_tpu/db``'s sqlite facade, schema and retry policy; the Postgres
facade is not ported, ROADMAP Queue A item 13b).

Reference parity: api/database.py (SQLAlchemy Core + `databases` pool over
Postgres). Neither is available in this environment, so this is an in-house
async facade over sqlite3 (WAL mode, multi-process safe) with a driver seam a
Postgres driver can plug into later.
"""

from vlog_tpu_torch.db.core import Database, Transaction
from vlog_tpu_torch.db.schema import create_all, SCHEMA_VERSION

__all__ = ["Database", "Transaction", "create_all", "SCHEMA_VERSION"]
