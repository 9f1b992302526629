"""The port's H.264 I+P chain ``GridProgram`` against the JAX package's
at the grid shapes with a rung axis of 2 or more over 4 to 8 devices
(1x4, 4x2, 2x4); the inputs and tolerance of
``tests/test_torch_grid_chain.py``.
"""

from __future__ import annotations

import pytest

from tests.test_torch_backend import one_torch_thread  # noqa: F401
from tests.test_torch_grid import SHAPES, assert_resize_agrees, shape_id
from tests.test_torch_grid_chain import CLEN, NC, check_chain_grid


@pytest.fixture(scope="module", autouse=True)
def resize_agrees():
    assert_resize_agrees(NC * CLEN)


@pytest.mark.parametrize("shape", SHAPES[3:], ids=shape_id)
def test_chain_grid_matches_jax_wide(shape):
    check_chain_grid(shape)
