"""Python side of the HEVC motion search kernel (csrc/hevc_motion_search.cu).

One launch does the whole per-block search of ``codecs/hevc/core.py``'s
``_p_ctb_search`` for every chain of a batch: the integer full search,
then the half- and quarter-pel refinement through the spec's luma
interpolation, bit-exact with the plain functions there
(``_integer_search``, ``_subpel_refine``). It replaces no Pallas kernel:
the JAX package's search (``vlog_tpu/codecs/hevc/jax_core.py``) is plain
``jnp``. ``_p_ctb_search`` sends a CPU tensor to the plain functions and
any other to :func:`p_ctb_search`, which launches the kernel or raises;
there is no fallback from one to the other. The source builds with
``nvcc`` for ``sm_90a`` at first use (ops/cuda_build.py) into a plain-C
shared library loaded with ctypes.

``launches`` counts the kernel's launches (one a call,
``LAUNCHES_PER_CALL``), so a run can show that its motion search went
through the kernel.
"""

from __future__ import annotations

import ctypes
import numbers
import threading
from pathlib import Path

import torch

from vlog_tpu_torch.ops import cuda_build

BLOCK_SIZES = (16, 32)
MAX_SEARCH = 32         # the kernel's limits (checked against the library)
MAX_LAM = 1 << 16
FRACS = 4               # luma quarter-pel fraction planes

LAUNCHES_PER_CALL = 1
launches = 0
build_log = ""          # nvcc's output of the last build (ptxas -v report)
build_seconds = 0.0

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()   # launches: each slot's dispatch thread launches
_LIB = None


def build_library() -> Path:
    """Compile csrc/hevc_motion_search.cu into the build directory
    (ops/cuda_build.py; raises on failure)."""
    global build_log, build_seconds
    built = cuda_build.build("hevc_motion_search.cu",
                             "libvt_hevc_motion_search.so")
    if built.log:
        build_log, build_seconds = built.log, built.seconds
    return built.path


def load_library():
    """The loaded kernel library; builds it first if needed. Raises."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build_library()))
            limits = (ctypes.c_int * 2)()
            lib.vt_hevc_motion_search_limits.restype = None
            lib.vt_hevc_motion_search_limits.argtypes = [ctypes.c_void_p]
            lib.vt_hevc_motion_search_limits(limits)
            if tuple(limits) != (MAX_SEARCH, MAX_LAM):
                raise RuntimeError(f"kernel limits {tuple(limits)} do not match "
                                   f"the wrapper's {(MAX_SEARCH, MAX_LAM)}")
            ptr, num = ctypes.c_void_p, ctypes.c_int
            fn = lib.vt_hevc_motion_search
            fn.restype = num
            fn.argtypes = [ptr] * 5 + [num] * 7 + [ptr]
            _LIB = lib
        return _LIB


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"hevc motion search: {msg}")


def _check_args(cur, refp, hplanes, search, pad, lam, n) -> None:
    """Everything the kernel takes, checked before any device work."""
    _check(n in BLOCK_SIZES, f"block size {n}, not one of {BLOCK_SIZES}")
    _check(isinstance(search, numbers.Integral) and 1 <= search <= MAX_SEARCH,
           f"search {search!r} outside 1..{MAX_SEARCH}")
    _check(isinstance(lam, numbers.Integral) and 0 <= lam <= MAX_LAM,
           f"lam {lam!r} outside 0..{MAX_LAM}")
    _check(isinstance(pad, numbers.Integral) and pad >= search + 4,
           f"pad {pad!r} below search + 4 (the refinement's 8-tap reach)")
    _check(all(t.dtype == torch.int32 for t in (cur, refp, hplanes)),
           f"dtypes {cur.dtype}/{refp.dtype}/{hplanes.dtype}, not int32")
    _check(cur.dim() == 3, f"cur {tuple(cur.shape)}, not (B, H, W)")
    b, h, w = cur.shape
    hp, wp = h + 2 * pad, w + 2 * pad
    _check(b >= 1 and h >= n and w >= n and h % n == 0 and w % n == 0,
           f"cur {tuple(cur.shape)} is not a whole grid of {n}x{n} blocks")
    _check(tuple(refp.shape) == (b, hp, wp),
           f"refp {tuple(refp.shape)}, want {(b, hp, wp)}")
    _check(tuple(hplanes.shape) == (b, FRACS, hp, wp),
           f"hplanes {tuple(hplanes.shape)}, want {(b, FRACS, hp, wp)}")
    _check(cur.is_contiguous() and refp.is_contiguous()
           and hplanes.is_contiguous(), "inputs must be contiguous")
    _check(b * (h // n) * (w // n) < 2 ** 31, "too many blocks")


def p_ctb_search(cur: torch.Tensor, refp: torch.Tensor, hplanes: torch.Tensor,
                 *, search: int, pad: int, lam: int = 2, n: int = 32):
    """cur (B, H, W) and refp (B, H + 2 pad, W + 2 pad) int32 holding
    uint8 samples (refp the edge-padded reference), hplanes (B, 4, H +
    2 pad, W + 2 pad) int32 (``_hfiltered_planes`` of refp with the luma
    taps), all contiguous on one CUDA device -> ((B, H/n, W/n, 2) int32
    quarter-pel MVs (y, x), (B, H/n, W/n) int32 costs). Raises on
    anything the kernel does not take."""
    global launches
    _check_args(cur, refp, hplanes, search, pad, lam, n)
    _check(cur.device.type == "cuda", f"tensors on {cur.device}, not CUDA")
    _check(refp.device == cur.device and hplanes.device == cur.device,
           "tensors must be on one device")
    lib = load_library()
    b, h, w = cur.shape
    mv = torch.empty((b, h // n, w // n, 2), dtype=torch.int32, device=cur.device)
    cost = torch.empty((b, h // n, w // n), dtype=torch.int32, device=cur.device)
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream(cur.device).cuda_stream
        rc = lib.vt_hevc_motion_search(
            cur.data_ptr(), refp.data_ptr(), hplanes.data_ptr(), mv.data_ptr(),
            cost.data_ptr(), b, h, w, int(pad), int(search), int(lam), n,
            stream)
    if rc != 0:
        raise RuntimeError(f"hevc motion search launch failed: CUDA error {rc}")
    with _COUNT_LOCK:
        launches += LAUNCHES_PER_CALL
    return mv, cost
