"""Plain separable resize: the ladder's lanczos3 matrices built here from
their definition, and ``uint8(clip(round((A_h @ x) @ A_w.T)))`` as two
products in ``dtype`` (float32 as the configuration states; the control
passes bfloat16). Nothing of the program is imported or reused."""

from __future__ import annotations

import numpy as np
import torch


def _lanczos3(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    out = np.where(x < 1e-8, 1.0, np.sinc(x) * np.sinc(x / 3.0))
    return np.where(x >= 3.0, 0.0, out)


def resample_matrix(src: int, dst: int) -> np.ndarray:
    """Dense (dst, src) lanczos3 matrix, centre convention, rows
    normalised; a downscale widens the kernel by src/dst."""
    scale = src / dst
    width = 3.0 * max(scale, 1.0)
    centers = (np.arange(dst) + 0.5) * scale
    positions = np.arange(src) + 0.5
    x = (positions[None, :] - centers[:, None]) / max(scale, 1.0)
    w = _lanczos3(x)
    w[np.abs(positions[None, :] - centers[:, None]) > width + 1e-9] = 0.0
    rowsum = w.sum(axis=1, keepdims=True)
    rowsum[rowsum == 0.0] = 1.0
    return (w / rowsum).astype(np.float32)


def rung_matrices(src_h: int, src_w: int, h: int, w: int):
    """((A_h, A_w), (chroma A_h, chroma A_w)) for one rung."""
    return ((resample_matrix(src_h, h), resample_matrix(src_w, w)),
            (resample_matrix(src_h // 2, h // 2),
             resample_matrix(src_w // 2, w // 2)))


def resize_plane(plane: torch.Tensor, a_h: np.ndarray, a_w: np.ndarray,
                 dtype=torch.float32) -> torch.Tensor:
    """(n, H, W) uint8 -> (n, h, w) uint8."""
    dev = plane.device
    ah = torch.as_tensor(a_h, device=dev).to(dtype)
    aw = torch.as_tensor(a_w, device=dev).to(dtype)
    x = torch.matmul(ah, plane.to(dtype))
    x = torch.matmul(x, aw.transpose(0, 1))
    return torch.clamp(torch.round(x.to(torch.float32)), 0, 255).to(torch.uint8)
