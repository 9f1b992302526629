"""Device-clock milliseconds of one decoder step in the window's engine
ticks: the median over the ticks that ended inside the window of each
tick's ``wall_s`` (``AsrEngine.batch_log``: CUDA events around the tick)
over its decoder steps (``steps`` plus the prompt's, the denominator of
``asr.step_ms``). None without the records."""

import statistics


def read(run):
    span = run.window.span
    if span is None:
        return None
    ticks = [b for b in run.engine.batch_log
             if "t1" in b and span[0] < b["t1"] <= span[1]]
    if not ticks or any(b["wall_s"] is None or not b["steps"] for b in ticks):
        return None
    return 1e3 * statistics.median(
        b["wall_s"] / (b["steps"] + len(run.prompt)) for b in ticks)
