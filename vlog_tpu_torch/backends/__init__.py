"""Accelerator backends (port of ``vlog_tpu/backends``).

Importing this package registers the built-in PyTorch/CUDA backend as
``"torch"``; others register themselves via :func:`register_backend`.
"""

from vlog_tpu_torch.backends.base import (  # noqa: F401
    Backend,
    Capabilities,
    ExecutionPlan,
    PlannedRung,
    RungResult,
    RunResult,
    available_backends,
    get_backend,
    plan_rung_geometry,
    register_backend,
    select_backend,
)
from vlog_tpu_torch.backends import torch_backend  # noqa: F401  (registers "torch")
