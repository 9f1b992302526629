"""Devices, grids and the ladder programs (port of ``vlog_tpu/parallel``).

The reference's re-exports resolve at first use: ``native/build.py`` and
``ops/fused_resize.py`` import ``parallel.compile_cache``, and the ladder
imports them, so importing the ladder with this package would close an
import cycle.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "executor": ("LaggedRateControl", "PipelineExecutor", "StagedBatch"),
    "mesh": ("MeshShape", "MeshSpec", "RungGrid", "balanced_rung_columns",
             "make_mesh", "parse_mesh_spec", "resolve_mesh_shape",
             "rung_grid", "shard_frames"),
    "scheduler": ("MeshScheduler", "SlotLease", "SlotTicket",
                  "current_lease", "get_scheduler", "grid_for_run",
                  "host_pool_for_run", "mesh_for_run"),
    "ladder": ("ladder_local", "ladder_matrices", "sharded_ladder_levels",
               "sharded_ladder_step", "single_chip_ladder"),
}
_OWNER = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_OWNER)


def __getattr__(name: str):
    mod = _OWNER.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
