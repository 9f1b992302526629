"""Share of the profiled engine tick's wall with no kernel running
(kernel intervals merged across streams)."""


def read(run):
    sl = run.profiler.slice
    share = None if sl is None else sl.idle_share()
    return None if share is None else 100.0 * share
