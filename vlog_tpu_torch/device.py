"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and asking for CUDA on a machine without it is an
error, never a silent fall back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def strict_fp32() -> None:
    """TF32 off for float32 matmuls and cuDNN convolutions (the package
    sets both at import; the ASR entry points set them again, since a
    caller may have turned them on): Whisper's float stages are held to
    the JAX reference's float32 results."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
