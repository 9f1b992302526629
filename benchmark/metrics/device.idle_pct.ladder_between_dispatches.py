"""Share of the window with no ladder dispatch on the device: one minus
the device-clock walls of the dispatches done inside the window
(``RunResult.dispatches``) over the window's span. The host phases
between dispatches (decode wait, planning, the entropy tail, each job's
probe, verify and manifest) are this share. None without the
records."""


def read(run):
    span = run.window.span
    if span is None or span[1] <= span[0]:
        return None
    recs = [r for j in run.jobs if "result" in j
            for r in getattr(j["result"].run, "dispatches", None) or ()
            if r["t_done"] is not None and span[0] <= r["t_done"] <= span[1]]
    if not recs or any(r["wall_s"] is None for r in recs):
        return None
    return 100.0 * (1.0 - sum(r["wall_s"] for r in recs) / (span[1] - span[0]))
