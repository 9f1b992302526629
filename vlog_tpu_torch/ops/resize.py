"""Separable ladder resampling: numpy matrices and the plain PyTorch product.

``resample_matrix`` and ``plan_ladder_matrices`` are copies of the JAX
package's numpy builders (``vlog_tpu/ops/resize.py``), so both packages
resize with the same float32 numbers. ``apply_resize_matrices`` is the
plain PyTorch version of the fused resize kernel (ops/fused_resize.py):
``uint8(clip(round_half_even((A_h @ f32(x)) @ A_w.T), 0, 255))`` with
both products in float32, in that order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _lanczos(x: np.ndarray, a: int = 3) -> np.ndarray:
    x = np.abs(x)
    out = np.where(x < 1e-8, 1.0, np.sinc(x) * np.sinc(x / a))
    return np.where(x >= a, 0.0, out)


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _box(x: np.ndarray) -> np.ndarray:
    return np.where(np.abs(x) <= 0.5, 1.0, 0.0)


_FILTERS = {
    "lanczos3": (_lanczos, 3.0),
    "bilinear": (_triangle, 1.0),
    "box": (_box, 0.5),
}


@functools.lru_cache(maxsize=256)
def resample_matrix(src: int, dst: int, filter: str = "lanczos3") -> np.ndarray:
    """Dense (dst, src) resampling matrix with normalized rows (centre
    convention; the kernel widens by src/dst on downscales)."""
    try:
        kernel, support = _FILTERS[filter]
    except KeyError:
        raise ValueError(f"unknown resize filter {filter!r}") from None
    scale = src / dst
    width = support * max(scale, 1.0)
    centers = (np.arange(dst) + 0.5) * scale
    positions = np.arange(src) + 0.5
    x = (positions[None, :] - centers[:, None]) / max(scale, 1.0)
    w = kernel(x)
    w[np.abs(positions[None, :] - centers[:, None]) > width + 1e-9] = 0.0
    rowsum = w.sum(axis=1, keepdims=True)
    rowsum[rowsum == 0.0] = 1.0
    return (w / rowsum).astype(np.float32)


def plan_ladder_matrices(src_h: int, src_w: int,
                         rungs_hw: tuple[tuple[int, int], ...],
                         filter: str = "lanczos3") -> dict:
    """{(h, w): ((A_h, A_w), (A_h_c, A_w_c)) | None} for every rung (None
    marks an identity, source-size rung). Fresh dict per call."""
    return dict(_plan_ladder_cached(src_h, src_w, tuple(rungs_hw), filter))


@functools.lru_cache(maxsize=64)
def _plan_ladder_cached(src_h: int, src_w: int,
                        rungs_hw: tuple[tuple[int, int], ...],
                        filter: str) -> tuple:
    if src_h % 2 or src_w % 2:
        raise ValueError("4:2:0 source dimensions must be even")
    mats = []
    for (h, w) in rungs_hw:
        if h % 2 or w % 2:
            raise ValueError(f"4:2:0 rung dimensions must be even: {(h, w)}")
        if (h, w) == (src_h, src_w):
            mats.append(((h, w), None))
            continue
        mats.append(((h, w), (
            (resample_matrix(src_h, h, filter), resample_matrix(src_w, w, filter)),
            (resample_matrix(src_h // 2, h // 2, filter),
             resample_matrix(src_w // 2, w // 2, filter)),
        )))
    return tuple(mats)


def apply_resize_matrices(plane: torch.Tensor, a_h: torch.Tensor,
                          a_w: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 x (h, H) x (w, W) -> (..., h, w) uint8."""
    x = plane.to(torch.float32)
    x = torch.matmul(a_h, x)
    x = torch.matmul(x, a_w.transpose(0, 1))
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def resize_yuv420_with(y, u, v, rung_mats, plane_fn=apply_resize_matrices):
    """Resize with prebuilt matrices (None = identity rung, which passes
    the uint8 planes through untouched)."""
    if rung_mats is None:
        return y, u, v
    (a_h, a_w), (c_h, c_w) = rung_mats
    return plane_fn(y, a_h, a_w), plane_fn(u, c_h, c_w), plane_fn(v, c_h, c_w)
