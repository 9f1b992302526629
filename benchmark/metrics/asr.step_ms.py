"""Host wall of one decoder step in the profiled tick: the tick's
batched generate call (encoder, cross K/V, prompt prefill and every beam
step) over its decoder steps (the prompt's and those its longest served
window needed)."""

from benchmark.reference.whisper import generated_lengths


def read(run):
    tick = next((k for k in run.ticks if k["profiled"]), None)
    if tick is None:
        return None
    steps = int(generated_lengths(tick["tokens"], run.tok["eot"]).max())
    return 1e3 * tick["gen_s"] / (steps + len(run.prompt))
