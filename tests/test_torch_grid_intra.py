"""The port's intra ``GridProgram`` against the JAX package's at every
grid shape (1x1, 2x1, 2x2, 1x4, 4x2, 2x4): 8 frames of
``test_torch_grid.content`` at 96x128, the four sweep rungs, per-frame
QPs; the port on ``["cpu"] * k``, JAX on its first k virtual devices
(its XLA resize plane). Tolerance: integer levels exact, ``sse_y``
within rtol 1e-5 (see ``tests/test_torch_grid.py``).
"""

from __future__ import annotations

import pytest

from tests.test_torch_backend import one_torch_thread  # noqa: F401
from tests.test_torch_grid import (H, RUNGS, SHAPES, W, assert_resize_agrees,
                                   compare, content, frame_qps, jax_grid,
                                   shape_id, torch_grid)

# slowlane-ok(module): 96x128, 8 frames; one JAX column program per rung
# column per shape

N = 8


@pytest.fixture(scope="module", autouse=True)
def resize_agrees():
    assert_resize_agrees(N)


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_intra_grid_matches_jax(shape):
    from vlog_tpu.parallel import ladder as jladder
    from vlog_tpu_torch.parallel import ladder as tladder
    from vlog_tpu_torch.parallel.executor import to_host

    y, u, v = content(N)
    q = frame_qps((N,))
    jprog = jladder.ladder_encode_grid(RUNGS, H, W, jax_grid(shape),
                                       pallas=False)
    tprog = tladder.ladder_encode_grid(RUNGS, H, W, torch_grid(shape),
                                       device="cpu")
    assert (tprog.data, tprog.label) == (jprog.data, jprog.label)
    compare(to_host(tprog.dispatch(y, u, v, q)), jprog.dispatch(y, u, v, q))
