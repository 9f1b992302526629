"""Python side of the H.264 deblocking kernel (csrc/h264_deblock.cu).

One launch runs the whole in-loop filter of
``codecs/h264/deblock.py::deblock_frame`` (spec 8.7) for every frame of
a batch: the wavefront over the anti-diagonals of macroblocks, each
diagonal's vertical then horizontal edges, luma and both chroma planes,
bit-exact with the plain version there. It replaces no Pallas kernel:
the JAX package's filter (``vlog_tpu/codecs/h264/deblock.py``) is plain
``jnp``. ``deblock_frame`` sends a CPU tensor to the plain wavefront and
any other to :func:`deblock`, which launches the kernel or raises; there
is no fallback from one to the other. The source builds with ``nvcc``
for ``sm_90a`` at first use (ops/cuda_build.py) into a plain-C shared
library loaded with ctypes.

``launches`` counts the kernel's launches (one a call,
``LAUNCHES_PER_CALL``), so a run can show that its deblocking went
through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from vlog_tpu_torch.ops import cuda_build

LAUNCHES_PER_CALL = 1
launches = 0
build_log = ""          # nvcc's output of the last build (ptxas -v report)
build_seconds = 0.0

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()   # launches: each slot's dispatch thread launches
_LIB = None


def build_library() -> Path:
    """Compile csrc/h264_deblock.cu into the build directory
    (ops/cuda_build.py; raises on failure)."""
    global build_log, build_seconds
    built = cuda_build.build("h264_deblock.cu", "libvt_h264_deblock.so")
    if built.log:
        build_log, build_seconds = built.log, built.seconds
    return built.path


def _tables() -> np.ndarray:
    """The plain version's tables in the library's order: alpha, beta,
    tc0 for bS 1-3, the chroma QP."""
    from vlog_tpu_torch.codecs.h264 import deblock, encoder

    return np.concatenate([deblock.ALPHA, deblock.BETA, deblock.TC0.ravel(),
                           encoder._CHROMA_QP]).astype(np.int32)


def load_library():
    """The loaded kernel library; builds it first if needed, and checks
    that its constant tables are the plain version's. Raises."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            want = _tables()
            held = (ctypes.c_int * want.size)()
            lib.vt_h264_deblock_tables.restype = None
            lib.vt_h264_deblock_tables.argtypes = [ctypes.c_void_p]
            lib.vt_h264_deblock_tables(held)
            if not np.array_equal(np.asarray(held, np.int32), want):
                raise RuntimeError("the kernel's deblocking tables differ "
                                   "from codecs/h264/deblock.py's")
            ptr, num, wide = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            fn = lib.vt_h264_deblock
            fn.restype = num
            fn.argtypes = [ptr] * 6 + [wide] * 2 + [ptr] * 3 + [num] * 3 \
                + [ptr]
            lib.vt_h264_deblock_threads.restype = num
            lib.vt_h264_deblock_threads.argtypes = [num, num]
            probe = lib.vt_h264_deblock_barrier_probe
            probe.restype = num
            probe.argtypes = [num, num, num, ptr, ptr]
            _LIB = lib
        return _LIB


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"h264 deblock: {msg}")


def _check_args(y, u, v, qp, bs_v, bs_h) -> list[int]:
    """Everything the kernel takes, checked before any device work;
    returns the batch strides of bs_v and bs_h (0 where unbatched)."""
    _check(all(p.dtype == torch.uint8 for p in (y, u, v)),
           f"planes {y.dtype}/{u.dtype}/{v.dtype}, not uint8")
    _check(y.dim() == 3 and u.dim() == 3 and v.dim() == 3,
           f"planes {tuple(y.shape)}/{tuple(u.shape)}/{tuple(v.shape)}, "
           "not (n, H, W)")
    n, h, w = y.shape
    _check(n >= 1 and h >= 16 and w >= 16 and h % 16 == 0 and w % 16 == 0,
           f"y {tuple(y.shape)} is not a whole grid of macroblocks")
    mbh, mbw = h // 16, w // 16
    _check(tuple(u.shape) == (n, h // 2, w // 2)
           and tuple(v.shape) == (n, h // 2, w // 2),
           f"chroma {tuple(u.shape)}/{tuple(v.shape)}, want "
           f"{(n, h // 2, w // 2)}")
    _check(qp.dtype == torch.int32 and tuple(qp.shape) == (n,),
           f"qp {qp.dtype} {tuple(qp.shape)}, want int32 {(n,)}")
    strides = []
    for name, bs in (("bs_v", bs_v), ("bs_h", bs_h)):
        _check(bs.dtype == torch.int32, f"{name} {bs.dtype}, not int32")
        _check(tuple(bs.shape) in ((n, mbh, mbw, 4, 4), (mbh, mbw, 4, 4)),
               f"{name} {tuple(bs.shape)}, want {(n, mbh, mbw, 4, 4)} or "
               f"{(mbh, mbw, 4, 4)}")
        strides.append(mbh * mbw * 16 if bs.dim() == 5 else 0)
    _check(all(t.is_contiguous() for t in (y, u, v, qp, bs_v, bs_h)),
           "inputs must be contiguous")
    _check(3 * n < 2 ** 31 and mbh * mbw * 256 < 2 ** 31, "too large")
    return strides


def deblock(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
            qp: torch.Tensor, bs_v: torch.Tensor, bs_h: torch.Tensor):
    """y (n, H, W), u and v (n, H/2, W/2) uint8 planes of whole
    macroblocks (the reconstructions the encoder and decoder make), qp (n,) int32, bs_v and bs_h (n, H/16, W/16, 4, 4) int32
    (or (H/16, W/16, 4, 4), one for every frame), all contiguous on one
    CUDA device -> the filtered (y, u, v) as new int32 planes. Raises on
    anything the kernel does not take."""
    global launches
    stride_v, stride_h = _check_args(y, u, v, qp, bs_v, bs_h)
    _check(y.device.type == "cuda", f"tensors on {y.device}, not CUDA")
    _check(all(t.device == y.device for t in (u, v, qp, bs_v, bs_h)),
           "tensors must be on one device")
    lib = load_library()
    n, h, w = y.shape
    out = [torch.empty(p.shape, dtype=torch.int32, device=y.device)
           for p in (y, u, v)]
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = lib.vt_h264_deblock(
            y.data_ptr(), u.data_ptr(), v.data_ptr(), qp.data_ptr(), bs_v.data_ptr(), bs_h.data_ptr(), stride_v,
            stride_h, *(p.data_ptr() for p in out), n, h // 16, w // 16,
            stream)
    if rc != 0:
        raise RuntimeError(f"h264 deblock launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        launches += LAUNCHES_PER_CALL
    return tuple(out)


def barrier_probe(threads: int, steps: int, device, *,
                  global_mem: bool) -> None:
    """Launch one block of ``threads`` threads that runs ``steps``
    dependent barrier steps with no filter work, on the current stream,
    each step's cells in shared memory or (``global_mem``) in device
    memory as the kernel's planes are: the step latency of the kernel's
    chain bound. Not counted in ``launches``."""
    lib = load_library()
    dev = torch.device(device)
    _check(dev.type == "cuda", f"{dev}, not CUDA")
    cells = torch.empty(2 * threads, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.vt_h264_deblock_barrier_probe(
            threads, steps, int(global_mem), cells.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"h264 deblock barrier probe failed: CUDA error {rc}")


def threads_per_block(mbh: int, mbw: int) -> int:
    """The block size of a call on an mbh x mbw macroblock frame."""
    return load_library().vt_h264_deblock_threads(mbh, mbw)
