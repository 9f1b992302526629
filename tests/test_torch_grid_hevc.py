"""The port's HEVC chain ``GridProgram`` (``hevc_chain_ladder_grid``)
against the JAX package's at every grid shape (1x1, 2x1, 2x2, 1x4, 4x2,
2x4): 4 chains of 2 frames of ``test_torch_grid.content`` at 96x128,
the four sweep rungs, search 2, per-frame QPs and the rate cascade live
(alpha 0.5), the in-loop filter off as in
``tests/test_torch_grid_chain.py`` (``tests/test_torch_grid_hevc_backend.py``
runs the deblocked grid end to end). The port on ``["cpu"] * k``, JAX on
its first k virtual devices. Tolerance: integer outputs exact, ``sse_y``
and ``cost`` within rtol 1e-5 (see ``tests/test_torch_grid.py``).
"""

from __future__ import annotations

import pytest

from tests.test_torch_backend import one_torch_thread  # noqa: F401
from tests.test_torch_grid import (H, RUNGS, SHAPES, W, assert_resize_agrees,
                                   chains, compare, frame_qps, jax_grid,
                                   rc_params, shape_id, torch_grid)

# slowlane-ok(module): 96x128, 4 chains of 2 frames, search 2

NC, CLEN, SEARCH = 4, 2, 2


@pytest.fixture(scope="module", autouse=True)
def resize_agrees():
    assert_resize_agrees(NC * CLEN)


@pytest.mark.parametrize("shape", SHAPES, ids=shape_id)
def test_hevc_grid_matches_jax(shape):
    from vlog_tpu.parallel.hevc_ladder import hevc_chain_ladder_grid as jgrid
    from vlog_tpu_torch.parallel.executor import to_host
    from vlog_tpu_torch.parallel.hevc_ladder import hevc_chain_ladder_grid

    y, u, v = chains(NC, CLEN)
    q = frame_qps((NC, CLEN))
    jprog = jgrid(RUNGS, H, W, search=SEARCH, grid=jax_grid(shape),
                  deblock=False, pallas=False)
    tprog = hevc_chain_ladder_grid(RUNGS, H, W, search=SEARCH,
                                   grid=torch_grid(shape), deblock=False,
                                   device="cpu")
    assert (tprog.data, tprog.label) == (jprog.data, jprog.label)
    compare(to_host(tprog.dispatch(y, u, v, q, rc_params())),
            jprog.dispatch(y, u, v, q, rc_params()))
