"""Job plane: pure state machine, claim protocol, dispatch queue (a copy
of ``vlog_tpu/jobs``: the same SQL over the same schema)."""

from vlog_tpu_torch.jobs.state import derive_state, JobStateError
from vlog_tpu_torch.jobs import claims

__all__ = ["derive_state", "JobStateError", "claims"]
