"""Observability of the port's device runtime: spans (:mod:`.trace`),
the process-wide runtime metrics registry (:mod:`.metrics`) and
duration-bounded ``torch.profiler`` sessions (:mod:`.profiler`)."""
