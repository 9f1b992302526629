"""The one ``nvcc`` build of the port's CUDA kernels (``csrc/*.cu``).

Each kernel module (``ops/fused_resize.py``, ``ops/motion_search.py``,
``ops/h264_deblock.py``)
compiles its source with :func:`build` into the build directory
(parallel/compile_cache.py: the package's ignored ``_build/`` unless
``VLOG_COMPILE_CACHE_DIR`` is set) as a plain-C shared library for
``sm_90a`` and loads it with ctypes. A library newer than its source is
reused; a missing ``nvcc`` or a failed build raises (there is no other
route to the card).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

from vlog_tpu_torch.parallel.compile_cache import (ensure_compile_cache,
                                                   note_build)

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


@dataclass(frozen=True)
class Built:
    path: Path
    log: str = ""           # nvcc's output (the ptxas -v report); "" when reused
    seconds: float = 0.0    # the compiler's wall seconds; 0.0 when reused


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                       "built on this machine")


def build(source: str, lib_name: str) -> Built:
    """Compile ``csrc/<source>`` into ``<build dir>/<lib_name>`` unless
    a library at least as new as the source is there. Raises."""
    src = CSRC / source
    so = Path(ensure_compile_cache()) / lib_name
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return Built(so)
    tmp = so.with_name(f"{lib_name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    note_build(seconds)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n"
                           f"{log[-4000:]}")
    os.replace(tmp, so)
    return Built(so, log, seconds)
