"""Device-clock milliseconds per source frame of the ladder dispatches
done inside the window: the ``wall_s`` of each ``RunResult.dispatches``
record (CUDA events on the compute stream around the dispatch's
launches) over their frames. None without the records."""


def read(run):
    span = run.window.span
    if span is None:
        return None
    recs = [r for j in run.jobs if "result" in j
            for r in getattr(j["result"].run, "dispatches", None) or ()
            if r["t_done"] is not None and span[0] <= r["t_done"] <= span[1]]
    if not recs or any(r["wall_s"] is None for r in recs):
        return None
    return 1e3 * sum(r["wall_s"] for r in recs) / sum(r["frames"] for r in recs)
