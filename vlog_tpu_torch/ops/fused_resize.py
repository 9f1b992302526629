"""Python side of the fused ladder resize kernel (csrc/fused_resize.cu).

Replaces ``vlog_tpu/ops/pallas_ladder.py::fused_resize_plane``. The CUDA
source is compiled with ``nvcc`` for ``sm_90a`` at first use into the
package's ignored ``_build/`` directory as a plain-C shared library and
loaded with ctypes. A CUDA tensor launches the kernel or raises; a CPU
tensor takes the plain PyTorch version (ops/resize.py
``apply_resize_matrices``). There is no fallback from one to the other.

``launches`` counts CUDA kernel launches so a run can show that its main
path went through the kernel. One plane call is ``LAUNCHES_PER_CALL``
launches: one for each of the two products.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from vlog_tpu_torch.ops.resize import apply_resize_matrices, resize_yuv420_with

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG / "csrc" / "fused_resize.cu"
_BUILD_DIR = _PKG / "_build"
_LIB_NAME = "libvt_fused_resize.so"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES_PER_CALL = 2
launches = 0
build_log = ""          # nvcc's output of the last build (ptxas -v report)
build_seconds = 0.0

_LOCK = threading.Lock()
_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the fused resize kernel cannot be "
                       "built on this machine")


def build_library() -> Path:
    """Compile csrc/fused_resize.cu into _build/ (raises on failure)."""
    global build_log, build_seconds
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = _BUILD_DIR / _LIB_NAME
    if so.exists() and so.stat().st_mtime >= _SOURCE.stat().st_mtime:
        return so
    tmp = _BUILD_DIR / f"{_LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log[-4000:]}")
    os.replace(tmp, so)
    return so


def load_library():
    """The loaded kernel library; builds it first if needed. Raises."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            fn = lib.vt_fused_resize_plane
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p])
            _LIB = lib
        return _LIB


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_resize_plane: {msg}")


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
    _check(plane.is_contiguous() and a_h.is_contiguous()
           and a_w.is_contiguous(), "inputs must be contiguous")
    lead = tuple(plane.shape[:-2])
    x = plane.reshape(-1, src_h, src_w)
    n = x.shape[0]
    out = torch.empty((n, dst_h, dst_w), dtype=torch.uint8, device=x.device)
    if n == 0:
        return out.reshape(lead + (dst_h, dst_w))
    scratch = torch.empty((n, dst_h, src_w), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.vt_fused_resize_plane(
            x.data_ptr(), a_h.data_ptr(), a_w.data_ptr(), scratch.data_ptr(),
            out.data_ptr(), n, src_h, src_w, dst_h, dst_w, stream)
    if rc != 0:
        raise RuntimeError(f"fused resize kernel launch failed: CUDA error {rc}")
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
