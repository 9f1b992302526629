"""The port's H.264 I+P chain ``GridProgram`` against the JAX package's
at the narrow grid shapes (1x1, 2x1, 2x2; the wide ones are in
``test_torch_grid_chain_wide.py``): 4 chains of 3 frames of
``test_torch_grid.content`` at 96x128, the four sweep rungs, search 2,
per-frame QPs and the in-chain rate adaptation live (alpha 0.5); the
in-loop filter off (it triples the JAX compile; a grid only places each
column's one-device program, which ``tests/test_torch_ladder.py`` holds
to JAX's with the filter on, and ``tests/test_torch_grid_backend.py``
runs the deblocked grid end to end). The port on ``["cpu"] * k``, JAX
on its first k virtual devices. Tolerance: integer outputs exact,
``sse_y`` and ``cost`` within rtol 1e-5 (see ``tests/test_torch_grid.py``).
"""

from __future__ import annotations

import pytest

from tests.test_torch_backend import one_torch_thread  # noqa: F401
from tests.test_torch_grid import (H, RUNGS, SHAPES, W, assert_resize_agrees,
                                   chains, compare, frame_qps, jax_grid,
                                   rc_params, shape_id, torch_grid)

# slowlane-ok(module): 96x128, 4 chains of 3 frames, search 2

NC, CLEN, SEARCH = 4, 3, 2


@pytest.fixture(scope="module", autouse=True)
def resize_agrees():
    assert_resize_agrees(NC * CLEN)


def check_chain_grid(shape) -> None:
    from vlog_tpu.parallel import ladder as jladder
    from vlog_tpu_torch.parallel import ladder as tladder
    from vlog_tpu_torch.parallel.executor import to_host

    y, u, v = chains(NC, CLEN)
    q = frame_qps((NC, CLEN))
    jprog = jladder.ladder_chain_grid(RUNGS, H, W, search=SEARCH,
                                      grid=jax_grid(shape), deblock=False,
                                      pallas=False)
    tprog = tladder.ladder_chain_grid(RUNGS, H, W, search=SEARCH,
                                      grid=torch_grid(shape), deblock=False,
                                      device="cpu")
    assert (tprog.data, tprog.label) == (jprog.data, jprog.label)
    compare(to_host(tprog.dispatch(y, u, v, q, rc_params())),
            jprog.dispatch(y, u, v, q, rc_params()))


@pytest.mark.parametrize("shape", SHAPES[:3], ids=shape_id)
def test_chain_grid_matches_jax(shape):
    check_chain_grid(shape)
