"""Windows over batch rows (before the beam fan-out) summed over the
engine's ticks in the window: how full the power-of-two buckets ran."""


def read(run):
    ticks = run.in_window()
    rows = sum(k["rows"] for k in ticks)
    return 100.0 * sum(k["n"] for k in ticks) / rows if rows else None
