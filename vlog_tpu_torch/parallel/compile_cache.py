"""The build directory of the port's compiled libraries and the
per-process build meter (the port's counterpart of
``vlog_tpu/parallel/compile_cache.py``).

The reference persists XLA programs across processes. The port compiles
no programs at run time; what it builds are its native libraries: the
resize kernel with ``nvcc`` (``ops/fused_resize.py::build_library``)
and the entropy coders and the libav shim with the C compiler
(``native/build.py``). Both build into :func:`build_dir` —
``VLOG_COMPILE_CACHE_DIR`` when set, else the package's ignored
``_build/`` — and rebuild only when a source is newer than its library,
so a warm directory costs nothing.

- :func:`ensure_compile_cache` creates that directory and returns it;
  the backends and the ASR engine call it before their first dispatch,
  as the reference's do.
- :func:`compile_seconds` meters this process's build seconds (each
  compiler run adds its wall seconds through :func:`note_build`): 0.0
  on a warm build directory.
"""

from __future__ import annotations

import threading
from pathlib import Path

from vlog_tpu_torch import config

_PKG = Path(__file__).resolve().parent.parent
_lock = threading.Lock()
_meter = {"seconds": 0.0}


def build_dir() -> Path:
    """Where the libraries build (read at every call)."""
    explicit = config.COMPILE_CACHE_DIR.strip()
    return Path(explicit).expanduser() if explicit else _PKG / "_build"


def ensure_compile_cache() -> str:
    """Create the build directory (idempotent) and return it."""
    d = build_dir()
    d.mkdir(parents=True, exist_ok=True)
    return str(d)


def note_build(seconds: float) -> None:
    """Add one compiler run's wall seconds to the meter."""
    with _lock:
        _meter["seconds"] += float(seconds)


def compile_seconds() -> float:
    """Cumulative library build seconds of this process."""
    with _lock:
        return _meter["seconds"]


def reset_for_tests() -> None:
    """Zero the meter."""
    with _lock:
        _meter["seconds"] = 0.0
