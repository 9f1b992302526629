"""Device operations recorded in the profiled ladder dispatch over its
source frames (every rung's resize, chain DSP, deblock and copies)."""


def read(run):
    sl = run.profiler.slice
    if sl is None or not sl.kernels:
        return None
    return len(sl.kernels) / sl.meta["frames"]
