"""Python side of the fused ladder resize kernel (csrc/fused_resize.cu).

Replaces ``vlog_tpu/ops/pallas_ladder.py::fused_resize_plane``. The CUDA
source is compiled with ``nvcc`` for ``sm_90a`` at first use
(ops/cuda_build.py) as a plain-C shared library and loaded with ctypes.
A CUDA tensor launches the kernel or raises; a CPU tensor takes the
plain PyTorch version (ops/resize.py ``apply_resize_matrices``). There
is no fallback from one to the other.

The kernel walks each matrix in its band form (ops/resize.py
``band_form``, rows in groups of ``GROUP``) plus the source window of
each output tile. Both are derived once per matrix tensor, on its first
call, and kept while the tensor lives and is not modified in place; a
later call with the same tensor launches with no host work beyond the
argument checks.

``launches`` counts CUDA kernel launches so a run can show that its main
path went through the kernel. One plane call is one launch
(``LAUNCHES_PER_CALL``): the streaming kernel when every tile's window
fits one shared-memory chunk, else the chunked one (the C side picks).
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from vlog_tpu_torch.ops import cuda_build
from vlog_tpu_torch.ops.resize import (apply_resize_matrices, band_form,
                                       resize_yuv420_with)

# The kernel's layout (csrc/fused_resize.cu, checked against the built
# library when it loads): band groups of GROUP rows, output tiles of
# TILE_H x TILE_W, column windows starting on a multiple of COL_ALIGN.
GROUP = 4
TILE_H, TILE_W = 32, 64
COL_ALIGN = 16

LAUNCHES_PER_CALL = 1
launches = 0
build_log = ""          # nvcc's output of the last build (ptxas -v report)
build_seconds = 0.0

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()   # launches: the dispatch and host threads launch
_LIB = None


def build_library() -> Path:
    """Compile csrc/fused_resize.cu into the build directory
    (ops/cuda_build.py; raises on failure)."""
    global build_log, build_seconds
    built = cuda_build.build("fused_resize.cu", "libvt_fused_resize.so")
    if built.log:
        build_log, build_seconds = built.log, built.seconds
    return built.path


def load_library():
    """The loaded kernel library; builds it first if needed. Raises."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            layout = (ctypes.c_int * 4)()
            lib.vt_fused_resize_layout.restype = None
            lib.vt_fused_resize_layout.argtypes = [ctypes.c_void_p]
            lib.vt_fused_resize_layout(layout)
            if tuple(layout) != (GROUP, TILE_H, TILE_W, COL_ALIGN):
                raise RuntimeError(f"kernel layout {tuple(layout)} does not match "
                                   f"the wrapper's {(GROUP, TILE_H, TILE_W, COL_ALIGN)}")
            ptr, num = ctypes.c_void_p, ctypes.c_int
            fn = lib.vt_fused_resize_plane
            fn.restype = num
            fn.argtypes = ([ptr, ptr] + [num] * 5 + [ptr, ptr, ptr, num, num, num] * 2
                           + [ptr])
            _LIB = lib
        return _LIB


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_resize_plane: {msg}")


@dataclass(frozen=True)
class _Band:
    """One matrix in the kernel's layout, on the matrix's device."""
    ref: weakref.ref            # the dense matrix tensor it was built from
    version: int | None         # that tensor's in-place version counter
    first: torch.Tensor         # (tiles * groups per tile,) int32, padded with 0
    taps: torch.Tensor          # (same, span, GROUP) float32, padded with zeros
    win: torch.Tensor           # (tiles, 2) int32 source window [lo, hi)
    span: int
    groups: int                 # groups with rows in the matrix
    widest: int                 # widest tile window, in source indices


_BANDS: dict[tuple[int, int], _Band] = {}


def _forget(key, ref) -> None:
    band = _BANDS.get(key)
    if band is not None and band.ref is ref:
        del _BANDS[key]


def _band_of(a: torch.Tensor, axis: int) -> _Band:
    """The band form of ``a`` as the kernel's rows (axis 0: 32-row tiles)
    or columns (axis 1: 64-column tiles), padded to whole tiles, with the
    source window of each tile; built on its first call."""
    key = (id(a), axis)
    version = None if a.is_inference() else a._version
    band = _BANDS.get(key)
    if band is not None and band.ref() is a and band.version == version:
        return band
    first, taps = band_form(a.detach().cpu().numpy(), GROUP)
    per_tile = (TILE_H if axis == 0 else TILE_W) // GROUP
    align = 1 if axis == 0 else COL_ALIGN
    groups = first.shape[0]
    starts = np.arange(0, groups, per_tile)
    lo = np.minimum.reduceat(first, starts) // align * align
    hi = np.maximum.reduceat(first, starts) + taps.shape[1]
    pad = starts.shape[0] * per_tile - groups
    first = np.pad(first, (0, pad))
    taps = np.pad(taps, ((0, pad), (0, 0), (0, 0)))
    dev = a.device
    band = _Band(ref=weakref.ref(a, functools.partial(_forget, key)),
                 version=version,
                 first=torch.from_numpy(first).to(dev),
                 taps=torch.from_numpy(taps).to(dev),
                 win=torch.from_numpy(np.stack([lo, hi], 1).astype(np.int32)).to(dev),
                 span=taps.shape[1], groups=groups, widest=int((hi - lo).max()))
    _BANDS[key] = band
    return band


def _launch(plane: torch.Tensor, a_h: torch.Tensor,
            a_w: torch.Tensor) -> torch.Tensor:
    global launches
    lib = load_library()
    _check(plane.device.type == "cuda", f"plane on {plane.device}, not CUDA")
    _check(a_h.device == plane.device and a_w.device == plane.device,
           "matrices must be on the plane's device")
    _check(plane.dtype == torch.uint8, f"plane dtype {plane.dtype}, not uint8")
    _check(a_h.dtype == torch.float32 and a_w.dtype == torch.float32,
           "matrices must be float32")
    _check(plane.dim() >= 2 and a_h.dim() == 2 and a_w.dim() == 2,
           "plane (..., H, W), a_h (h, H), a_w (w, W)")
    src_h, src_w = plane.shape[-2], plane.shape[-1]
    dst_h, dst_w = a_h.shape[0], a_w.shape[0]
    _check(a_h.shape[1] == src_h and a_w.shape[1] == src_w,
           f"matrix shapes {tuple(a_h.shape)}/{tuple(a_w.shape)} do not "
           f"match plane {tuple(plane.shape)}")
    _check(src_h > 0 and src_w > 0, f"empty source plane {tuple(plane.shape)}")
    _check(plane.is_contiguous() and a_h.is_contiguous()
           and a_w.is_contiguous(), "inputs must be contiguous")
    lead = tuple(plane.shape[:-2])
    x = plane.reshape(-1, src_h, src_w)
    n = x.shape[0]
    out = torch.empty((n, dst_h, dst_w), dtype=torch.uint8, device=x.device)
    if out.numel() == 0:
        return out.reshape(lead + (dst_h, dst_w))
    _check(n * -(-dst_h // TILE_H) * -(-dst_w // TILE_W) < 2 ** 31,
           f"too many output tiles in {tuple(plane.shape)}")
    bh, bw = _band_of(a_h, 0), _band_of(a_w, 1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vt_fused_resize_plane(
            x.data_ptr(), out.data_ptr(), n, src_h, src_w, dst_h, dst_w,
            bh.first.data_ptr(), bh.taps.data_ptr(), bh.win.data_ptr(), bh.span,
            bh.groups, bh.widest, bw.first.data_ptr(), bw.taps.data_ptr(),
            bw.win.data_ptr(), bw.span, bw.groups, bw.widest, stream)
    if rc != 0:
        raise RuntimeError(f"fused resize kernel launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        launches += LAUNCHES_PER_CALL
    return out.reshape(lead + (dst_h, dst_w))


def fused_resize_plane(plane: torch.Tensor, a_h: torch.Tensor,
                       a_w: torch.Tensor) -> torch.Tensor:
    """(..., H, W) uint8 x (h, H) x (w, W) -> (..., h, w) uint8.

    CPU tensors take the plain version; any other device goes to the
    kernel, which raises if it cannot build, load or launch."""
    if plane.device.type == "cpu":
        return apply_resize_matrices(plane, a_h, a_w)
    return _launch(plane, a_h, a_w)


def resize_yuv420(y, u, v, rung_mats):
    """Resize one rung's Y/U/V through the kernel; identity rungs (mats
    None) stay out of it and pass the uint8 planes through."""
    return resize_yuv420_with(y, u, v, rung_mats, plane_fn=fused_resize_plane)
