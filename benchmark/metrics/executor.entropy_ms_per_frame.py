"""Host entropy-coding busy milliseconds per source frame:
``RunResult.stage_s["entropy_s"]`` (summed over the rungs' consumer
threads) over the frames of the jobs that finished in the window."""


def read(run):
    jobs = run.finished()
    frames = sum(j["result"].run.frames_processed for j in jobs)
    if not frames:
        return None
    return 1e3 * sum(j["result"].run.stage_s["entropy_s"] for j in jobs) / frames
