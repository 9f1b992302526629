"""Host milliseconds per source frame spent queueing the ladder
dispatches done inside the window (``t_enqueue1 - t_enqueue0`` of each
``RunResult.dispatches`` record: the time inside the program's
``dispatch``). Near ``executor.dispatch_wall_ms_per_frame``, the
launches set the device's pace. None without the records."""


def read(run):
    span = run.window.span
    if span is None:
        return None
    recs = [r for j in run.jobs if "result" in j
            for r in getattr(j["result"].run, "dispatches", None) or ()
            if r["t_done"] is not None and span[0] <= r["t_done"] <= span[1]]
    if not recs:
        return None
    return 1e3 * sum(r["t_enqueue1"] - r["t_enqueue0"] for r in recs) / sum(
        r["frames"] for r in recs)
