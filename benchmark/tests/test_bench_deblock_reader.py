"""The reader of ``h264.deblock_kernel_ms_per_frame`` on synthetic
slices: the H.264 deblocking kernel's summed device time over the
profiled dispatch's frames, found by the kernel's name (either of its
instantiations); None without a slice, and None where no kernel has that
name (a program that filters in plain PyTorch)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.trace import Slice

DB = ("void (anonymous namespace)::h264_deblock_kernel<unsigned char>"
      "(unsigned char const*)")


def _read(sl):
    run = SimpleNamespace(profiler=SimpleNamespace(slice=sl))
    return spec.load_reader("h264.deblock_kernel_ms_per_frame")(run)


def test_sums_the_kernels_of_that_name_over_the_frames():
    sl = Slice(kernels=[(DB, 0.0, 400.0), ("elementwise_kernel", 500.0, 9.0),
                        ("h264_deblock_barrier_probe", 600.0, 50.0),
                        (DB.replace("unsigned char", "int"), 900.0, 380.0)],
               wall_s=1.0, meta={"frames": 144})
    assert _read(sl) == pytest.approx((400.0 + 380.0) / 1e3 / 144)


@pytest.mark.parametrize("sl", [
    None,
    Slice(kernels=[], wall_s=1.0, meta={"frames": 144}),
    Slice(kernels=[("elementwise_kernel", 0.0, 500.0)], wall_s=1.0,
          meta={"frames": 144}),
])
def test_none_without_the_kernel(sl):
    assert _read(sl) is None
