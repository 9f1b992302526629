"""Summed device milliseconds of the H.264 deblocking kernel
(``h264_deblock_kernel``, found by name) in the profiled H.264 ladder
dispatch over its source frames. None where the slice holds no such
kernel: a program without it filters in plain PyTorch operations."""

KERNEL = "h264_deblock_kernel"


def read(run):
    sl = run.profiler.slice
    if sl is None or not sl.kernels:
        return None
    took = [d for name, _, d in sl.kernels if KERNEL in name]
    if not took:
        return None
    return sum(took) / 1e3 / sl.meta["frames"]
