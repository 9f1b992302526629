"""Milliseconds per source frame the dispatch thread waited on the
decode prefetch: ``RunResult.stage_s["decode_wait_s"]`` over the frames
of the jobs that finished in the window."""


def read(run):
    jobs = run.finished()
    frames = sum(j["result"].run.frames_processed for j in jobs)
    if not frames:
        return None
    return 1e3 * sum(j["result"].run.stage_s["decode_wait_s"]
                     for j in jobs) / frames
