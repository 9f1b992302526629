"""Share of an unprofiled engine tick's device wall with no kernel
running: the profiled tick's merged kernel time (the same work with or
without the profiler) against the median device-clock ``wall_s`` of the
ticks that ended inside the window with the profiled tick's rows and
decoder steps (``AsrEngine.batch_log``). None without the records or
the slice, or when no window tick has that shape."""

import statistics


def read(run):
    span, sl = run.window.span, run.profiler.slice
    prof = next((k for k in run.ticks if k["profiled"]), None)
    if span is None or sl is None or not sl.kernels or prof is None:
        return None
    log = [b for b in run.engine.batch_log if "t1" in b]
    # the profiled tick's own entry: the last one written before its tap
    # returned (ticks run one at a time on the tick thread)
    own = max((b for b in log if b["t1"] <= prof["t"]),
              key=lambda b: b["t1"], default=None)
    if own is None or own["rows"] != prof["rows"]:
        return None
    same = [b["wall_s"] for b in log
            if span[0] < b["t1"] <= span[1] and b["rows"] == own["rows"]
            and b["steps"] == own["steps"]]
    if not same or any(w is None for w in same):
        return None
    return 100.0 * (1.0 - sl.busy_s / statistics.median(same))
