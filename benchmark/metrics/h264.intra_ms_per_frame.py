"""Host milliseconds of the profiled H.264 ladder dispatch's ``h264.intra``
spans (the chains' I frames, their encode without the filter) over its
source frames: the summed durations of the host events of that name in
the slice. The dispatch thread queues its kernels as it goes, so a
span's host time is the time its step holds the thread. None where the
slice holds no such span: a program without the H.264 path's spans reads
nothing."""

SPAN = "h264.intra"


def read(run):
    sl = run.profiler.slice
    if sl is None or not sl.host_ops:
        return None
    took = [d for n, _, d in sl.host_ops if n == SPAN]
    if not took:
        return None
    return sum(took) / 1e3 / sl.meta["frames"]
