"""Device operations recorded in the profiled H.264 ladder dispatch over
its source frames (the chain DSP's intra, search, compensation,
residual, deblocking and rate-cascade kernels, and the copies)."""


def read(run):
    sl = run.profiler.slice
    if sl is None or not sl.kernels:
        return None
    return len(sl.kernels) / sl.meta["frames"]
