"""Tokens served per window (generated tokens up to and including the
first end-of-text) over the windows of the ticks in the window."""

from benchmark.reference.whisper import generated_lengths


def read(run):
    lens = [int(x) for k in run.in_window()
            for x in generated_lengths(k["tokens"], run.tok["eot"])]
    return sum(lens) / len(lens) if lens else None
