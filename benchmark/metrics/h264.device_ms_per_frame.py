"""Summed kernel milliseconds of the profiled H.264 ladder dispatch over
its source frames."""


def read(run):
    sl = run.profiler.slice
    if sl is None or not sl.kernels:
        return None
    return 1e3 * sl.kernel_s / sl.meta["frames"]
