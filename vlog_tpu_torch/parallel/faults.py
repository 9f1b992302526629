"""Device-fault classification: which failures are the HARDWARE's fault
(port of ``vlog_tpu/parallel/faults.py``, classifying the CUDA runtime's
errors instead of XLA's).

A sick accelerator is neither the job's fault nor the worker process's:
a CUDA runtime error escaping the compute thread (an illegal address, a
device-side assert, an exhausted or corrupted device memory) says
nothing about the input. The daemon and remote worker consult this
oracle before attributing a failed attempt:

- :func:`is_device_fault` — True for exceptions that originated in the
  device runtime (the CUDA error types by name, plus the message shapes
  the CUDA runtime, cuBLAS and cuDNN raise as bare ``RuntimeError``).
  Input/codec errors (``ValueError``, ``OSError``, validation failures)
  never classify; they stay transient/permanent.
- :class:`SyntheticDeviceFault` — the CUDA-shaped error the
  ``device.fault`` failpoint injects inside the compute thread, so chaos
  runs exercise exactly the classification path a real sick card takes.
"""

from __future__ import annotations

from vlog_tpu_torch.utils import failpoints

__all__ = ["SyntheticDeviceFault", "is_device_fault",
           "maybe_inject_device_fault"]

# Exception type NAMES (not imports: torch.cuda.OutOfMemoryError and
# torch.AcceleratorError exist only in some torch versions).
_DEVICE_ERROR_TYPES = frozenset({
    "OutOfMemoryError",      # torch.cuda.OutOfMemoryError
    "AcceleratorError",      # torch.AcceleratorError (CUDA runtime errors)
})

# Message shapes the runtime raises as bare RuntimeError. Matched only
# on RuntimeError-family exceptions so an input error whose *text*
# mentions a device cannot classify.
_DEVICE_MESSAGE_PATTERNS = (
    "cuda error:",                       # C10_CUDA_CHECK failures
    "cublas_status_",                    # cuBLAS status codes
    "cudnn error",
    "an illegal memory access",
    "device-side assert triggered",
    "out of memory",
)


class SyntheticDeviceFault(RuntimeError):
    """The ``device.fault`` failpoint's payload: a CUDA-shaped runtime
    error raised inside the compute thread, classified exactly like a
    real device fault (see :func:`is_device_fault`)."""


def is_device_fault(exc: BaseException) -> bool:
    """Did this failure originate in the accelerator runtime?

    Walks the ``__cause__``/``__context__`` chain (bounded) so a device
    error wrapped by pipeline plumbing still classifies. Deliberately
    conservative: only known runtime error type names, or RuntimeErrors
    carrying the runtime's message shapes, qualify.
    """
    seen = 0
    cur: BaseException | None = exc
    while cur is not None and seen < 8:
        if isinstance(cur, SyntheticDeviceFault):
            return True
        if isinstance(cur, failpoints.FailpointError):
            # a *different* armed failpoint (backend.*, storage.*) is an
            # injected plumbing fault, never a device fault
            return False
        if type(cur).__name__ in _DEVICE_ERROR_TYPES:
            return True
        if isinstance(cur, RuntimeError):
            msg = str(cur).lower()
            if any(p in msg for p in _DEVICE_MESSAGE_PATTERNS):
                return True
        seen += 1
        cur = cur.__cause__ or cur.__context__
    return False


def maybe_inject_device_fault() -> None:
    """The ``device.fault`` failpoint site (compute thread, start of the
    backend ladder run). Armed, it raises a :class:`SyntheticDeviceFault`
    whose message mirrors a real CUDA fault."""
    try:
        failpoints.hit("device.fault")
    except failpoints.FailpointError as exc:
        raise SyntheticDeviceFault(
            "CUDA error: an illegal memory access was encountered "
            "(synthetic device.fault)"
        ) from exc
