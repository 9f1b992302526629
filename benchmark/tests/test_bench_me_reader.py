"""The reader of ``hevc.me_ms_per_frame`` on synthetic slices: the
motion search kernel's summed device time over the profiled dispatch's
frames, found by the kernel's name; None without a slice, and None where
no kernel has that name (a program that searches in plain PyTorch)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.trace import Slice

ME = "void (anonymous namespace)::hevc_motion_search_kernel<32>(int const*)"


def _read(sl):
    run = SimpleNamespace(profiler=SimpleNamespace(slice=sl))
    return spec.load_reader("hevc.me_ms_per_frame")(run)


def test_sums_the_kernels_of_that_name_over_the_frames():
    sl = Slice(kernels=[(ME, 0.0, 150.0), ("other_kernel", 200.0, 900.0),
                        (ME.replace("<32>", "<16>"), 1200.0, 90.0)],
               wall_s=1.0, meta={"frames": 144})
    assert _read(sl) == pytest.approx((150.0 + 90.0) / 1e3 / 144)


@pytest.mark.parametrize("sl", [
    None,
    Slice(kernels=[], wall_s=1.0, meta={"frames": 144}),
    Slice(kernels=[("reduce_kernel", 0.0, 500.0)], wall_s=1.0,
          meta={"frames": 144}),
])
def test_none_without_the_kernel(sl):
    assert _read(sl) is None
