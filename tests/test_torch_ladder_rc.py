"""The chain ladder program with the device-side in-chain rate
adaptation, port against JAX (same setup and tolerances as
tests/test_torch_ladder.py). ``cost`` is the float32 ``cost_proxy``
sum (rtol 1e-5); the ``qp_eff`` it drives must be identical, and the
budgets are set so the adaptation actually moves QPs on this seed.
"""

from __future__ import annotations

import numpy as np

from tests.test_torch_ladder import RUNGS, compare, run_both


def test_chain_program_matches_jax_with_rc():
    rc = {name: {"budget": np.float32(b), "alpha": np.float32(a)}
          for (name, *_), b, a in zip(RUNGS, (60.0, 40.0, 20.0, 10.0),
                                      (0.35, 0.3, 0.25, 0.2))}
    got, want, q = run_both(rc, rc)
    compare(got, want)
    moved = sum(int(np.any(got[n]["qp_eff"].numpy()[:, 1:] != q[n][:, 1:]))
                for n in got)
    assert moved >= 2, "the in-chain adaptation never changed a QP"
