"""The fused resize kernel's share of its roofline in the profiled
ladder dispatch: the least time its calls could take (each input byte
read and each output byte written once at the HBM rate, against two
operations per nonzero tap at the float32 rate: ``benchmark/flops.py``)
over the time its kernels took."""


def read(run):
    return run.resize_roofline_pct()
