"""Summed device milliseconds of the HEVC motion search kernel
(``hevc_motion_search_kernel``, found by name) in the profiled ladder
dispatch over its source frames. None where the slice holds no such
kernel: a program without it searches in plain PyTorch operations."""

KERNEL = "hevc_motion_search_kernel"


def read(run):
    sl = run.profiler.slice
    if sl is None or not sl.kernels:
        return None
    took = [d for name, _, d in sl.kernels if KERNEL in name]
    if not took:
        return None
    return sum(took) / 1e3 / sl.meta["frames"]
