"""Share of an unprofiled ladder dispatch's device wall with no kernel
running: the profiled dispatch's merged kernel time per frame (its busy
time is the same work with or without the profiler) against the
device-clock wall per frame of the dispatches done inside the window
(``RunResult.dispatches``). None without the records or the slice, or
when a window dispatch holds another number of frames than the profiled
one."""


def read(run):
    span, sl = run.window.span, run.profiler.slice
    if span is None or sl is None or not sl.kernels:
        return None
    recs = [r for j in run.jobs if "result" in j
            for r in getattr(j["result"].run, "dispatches", None) or ()
            if r["t_done"] is not None and span[0] <= r["t_done"] <= span[1]]
    frames = sl.meta["frames"]
    if not recs or any(r["wall_s"] is None or r["frames"] != frames
                       for r in recs):
        return None
    wall_per_frame = sum(r["wall_s"] for r in recs) / sum(
        r["frames"] for r in recs)
    return 100.0 * (1.0 - sl.busy_s / frames / wall_per_frame)
