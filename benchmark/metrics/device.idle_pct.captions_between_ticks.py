"""Share of the window with no engine tick on the device: one minus the
device-clock ``wall_s`` of the ticks that ended inside the window
(``AsrEngine.batch_log``) over the window's span. The engine's time
between ticks (the coalesce sleep, the lease, the take, the host work
of the jobs' threads it waits on) is this share. None without the
records."""


def read(run):
    span = run.window.span
    if span is None or span[1] <= span[0]:
        return None
    ticks = [b for b in run.engine.batch_log
             if "t1" in b and span[0] < b["t1"] <= span[1]]
    if not ticks or any(b["wall_s"] is None for b in ticks):
        return None
    return 100.0 * (1.0 - sum(b["wall_s"] for b in ticks) / (span[1] - span[0]))
