"""Share of finished jobs' wall outside ``ProcessResult.step_s["ladder"]``:
probe, plan, verify, manifest and the rest of ``process_video`` around
the backend run (host clock, the jobs that finished in the window)."""


def read(run):
    jobs = run.finished()
    wall = sum(j["t1"] - j["t0"] for j in jobs)
    if not jobs or wall <= 0:
        return None
    ladder = sum(j["result"].step_s["ladder"] for j in jobs)
    return 100.0 * (wall - ladder) / wall
