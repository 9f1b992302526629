"""Observability of the port's device runtime: spans (:mod:`.trace`),
the process-wide runtime metrics registry and the HTTP plane's
(:mod:`.metrics`), the SLO plane (:mod:`.slo`) and duration-bounded
``torch.profiler`` sessions (:mod:`.profiler`)."""
