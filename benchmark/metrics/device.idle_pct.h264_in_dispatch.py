"""Share of an unprofiled H.264 ladder dispatch's device wall with no
kernel running: the profiled dispatch's merged kernel time per frame
(its busy time is the same work with or without the profiler) against
the device-clock wall per frame of the dispatches of every job that ran
to its end (``RunResult.dispatches``, the H.264 path's
``timed_dispatch`` records; the profiled job is stopped after its
dispatch and never ends). Not only the window's: a job lasts about half
the window, and a traced run's jobs may leave none ending inside it.
None without the records or the slice (a program whose H.264 path keeps
no records), or when a dispatch holds another number of frames than
the profiled one."""


def read(run):
    sl = run.profiler.slice
    if sl is None or not sl.kernels:
        return None
    recs = [r for j in run.jobs if "result" in j
            for r in getattr(j["result"].run, "dispatches", None) or ()
            if r["t_done"] is not None]
    frames = sl.meta["frames"]
    if not recs or any(r["wall_s"] is None or r["frames"] != frames
                       for r in recs):
        return None
    wall_per_frame = sum(r["wall_s"] for r in recs) / sum(
        r["frames"] for r in recs)
    return 100.0 * (1.0 - sl.busy_s / frames / wall_per_frame)
