"""The SLO plane's read side the job plane calls (the part of
``vlog_tpu/obs/slo.py`` a worker process reaches).

``jobs/qos.py::fleet_snapshot`` floors its scale hint while a jobs-plane
objective burns its error budget, reading the names alerting as of the
plane's last evaluation. The evaluation (burn-rate windows over the
runtime registry and ``job_spans``) runs in the admin process, which the
port does not serve: in a worker process nothing evaluates, so the last
report stays empty and :func:`alerting_objectives` returns ``[]``, as the
JAX package's does there.
"""

from __future__ import annotations

import threading

# The last evaluation's report ({"objectives": [{"name", "alerting"}]}),
# None until something evaluates. Nothing in the port does.
_last_report: dict | None = None           # guarded-by: _lock
_lock = threading.Lock()


def alerting_objectives() -> list[str]:
    """Objective names alerting as of the last evaluation; never raises
    and never touches the database."""
    with _lock:
        report = _last_report
    if not report:
        return []
    return [o["name"] for o in report["objectives"] if o["alerting"]]
