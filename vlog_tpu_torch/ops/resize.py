"""Separable ladder resampling: numpy matrices, the plain PyTorch product,
and the one-call resize API.

``resample_matrix`` and ``plan_ladder_matrices`` are copies of the JAX
package's numpy builders (``vlog_tpu/ops/resize.py``), so both packages
resize with the same float32 numbers; ``band_form`` is the layout the
fused kernel walks instead of the dense matrix. ``apply_resize_matrices`` is the
plain PyTorch version of the fused resize kernel (ops/fused_resize.py):
``uint8(clip(round_half_even((A_h @ f32(x)) @ A_w.T), 0, 255))`` with
both products in float32, in that order.

``resize_plane``, ``resize_yuv420`` and ``ladder_resize_yuv420`` take the
reference's signatures: the target size instead of matrices, which are
built once per (source, target, filter, device) and kept. A uint8 plane
resized to uint8 goes through ``fused_resize_plane``: the kernel on a
CUDA tensor, its plain version on a CPU tensor. A float source or a
float result is a function the kernel does not compute: those take the
two float32 products (TF32 is off, see the package's ``__init__``).
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


def band_form(a: np.ndarray, group: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Band form of a dense (dst, src) matrix, the fused kernel's layout.

    Rows go ``group`` at a time. Group g has one window of ``span``
    source indices from ``first[g]`` that holds every nonzero of its
    rows, and ``taps[g, s, i] == a[g * group + i, first[g] + s]`` (zero
    for a row past ``dst``). ``span`` is the widest group's window; a
    window that would run past ``src`` starts further left, so every
    padding tap still indexes a source element. Scattering ``taps`` back
    gives ``a`` exactly. Any matrix works (a dense one has
    ``span == src``). Returns ``(first (groups,) int32, taps (groups,
    span, group) float32)``.
    """
    a = np.asarray(a, np.float32)
    dst, src = a.shape
    groups = -(-dst // group)
    rows = np.zeros((groups * group, src), np.float32)
    rows[:dst] = a
    rows = rows.reshape(groups, group, src)
    nz = (rows != 0).any(1)
    has = nz.any(1)
    lo = np.where(has, nz.argmax(1), 0)
    hi = np.where(has, src - nz[:, ::-1].argmax(1), 1)
    span = int((hi - lo).max(initial=1))
    first = np.minimum(lo, src - span).astype(np.int32)
    cols = first[:, None] + np.arange(span)
    taps = np.take_along_axis(rows, cols[:, None, :], axis=2)
    return first, np.ascontiguousarray(taps.transpose(0, 2, 1))


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


def _products(plane: torch.Tensor, a_h: torch.Tensor,
              a_w: torch.Tensor) -> torch.Tensor:
    """(A_h @ f32(plane)) @ A_w.T in float32."""
    x = torch.matmul(a_h, plane.to(torch.float32))
    return torch.matmul(x, a_w.transpose(0, 1))


def _to_uint8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def apply_resize_matrices(plane: torch.Tensor, a_h: torch.Tensor,
                          a_w: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 x (h, H) x (w, W) -> (..., h, w) uint8."""
    return _to_uint8(_products(plane, a_h, a_w))


def resize_yuv420_with(y, u, v, rung_mats, plane_fn=apply_resize_matrices):
    """Resize with prebuilt matrices (None = identity rung, which passes
    the uint8 planes through untouched)."""
    if rung_mats is None:
        return y, u, v
    (a_h, a_w), (c_h, c_w) = rung_mats
    return plane_fn(y, a_h, a_w), plane_fn(u, c_h, c_w), plane_fn(v, c_h, c_w)


@functools.lru_cache(maxsize=256)
def _device_matrix(src: int, dst: int, filter: str,
                   device: str) -> torch.Tensor:
    """``resample_matrix`` as a float32 tensor on ``device``, one tensor
    per key: the kernel derives a matrix's band form once per tensor."""
    return torch.tensor(resample_matrix(src, dst, filter), device=device)


def resize_plane(plane: torch.Tensor, dst_h: int, dst_w: int, *,
                 filter: str = "lanczos3", out_dtype=torch.uint8
                 ) -> torch.Tensor:
    """Resize a (..., H, W) plane to (..., dst_h, dst_w) on its device.

    Rows then columns; the result is rounded half to even and clipped to
    ``out_dtype`` uint8, or kept as float32 products cast to another
    ``out_dtype`` (for chained ops)."""
    from vlog_tpu_torch.ops.fused_resize import fused_resize_plane

    dev = str(plane.device)
    a_h = _device_matrix(plane.shape[-2], dst_h, filter, dev)
    a_w = _device_matrix(plane.shape[-1], dst_w, filter, dev)
    if out_dtype == torch.uint8 and plane.dtype == torch.uint8:
        return fused_resize_plane(plane.contiguous(), a_h, a_w)
    x = _products(plane, a_h, a_w)
    return _to_uint8(x) if out_dtype == torch.uint8 else x.to(out_dtype)


def resize_yuv420(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  dst_h: int, dst_w: int, *, filter: str = "lanczos3"):
    """Resize a planar 4:2:0 frame batch to uint8; dst_h/dst_w must be
    even. An identity size resizes nothing: uint8 planes come back as
    they are, float planes rounded and clipped to uint8."""
    if dst_h % 2 or dst_w % 2:
        raise ValueError("4:2:0 target dimensions must be even")
    if (y.shape[-2], y.shape[-1]) == (dst_h, dst_w):
        if y.dtype != torch.uint8:
            return _to_uint8(y), _to_uint8(u), _to_uint8(v)
        return y, u, v
    return (resize_plane(y, dst_h, dst_w, filter=filter),
            resize_plane(u, dst_h // 2, dst_w // 2, filter=filter),
            resize_plane(v, dst_h // 2, dst_w // 2, filter=filter))


def ladder_resize_yuv420(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         rungs, *, filter: str = "lanczos3") -> dict:
    """One source -> every rung: {(h, w): (Y, U, V)} for each (height,
    width) in ``rungs``."""
    return {(h, w): resize_yuv420(y, u, v, h, w, filter=filter)
            for (h, w) in rungs}
