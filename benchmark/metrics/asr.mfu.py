"""Whisper operations of the real rows of the ticks in the window
(``benchmark/flops.py``: encoder, cross K/V, every decoder step over the
positions cached so far, padding rows left out) per second of the
window, against the card's float32 peak (the port runs TF32 off)."""


def read(run):
    return run.mfu_pct()
