"""Host CABAC busy milliseconds per source frame of the H.264 ladder:
``RunResult.stage_s["entropy_s"]`` (summed over the rungs' consumer
threads) over the frames of every job that ran to its end. Not only
those that ended inside the window: a job lasts about half the window,
and a traced run's jobs, slower than an untraced run's, may leave none
ending inside it."""


def read(run):
    jobs = [j for j in run.jobs if "result" in j]
    frames = sum(j["result"].run.frames_processed for j in jobs)
    if not frames:
        return None
    return 1e3 * sum(j["result"].run.stage_s["entropy_s"] for j in jobs) / frames
