"""Build and load the native CABAC slice coder (ctypes).

Sources are copies of the JAX package's C coder: ``h264_cabac_enc.c``
and ``cabac_engine.h`` verbatim, ``escape.c`` (NAL emulation
prevention). The three ``*.inc`` table headers are committed as
generated by ``vlog_tpu/native/gen_tables.py``,
``gen_h264_cabac_tables.py`` and ``gen_hevc_tables.py`` (each file's
first line names its generator).

The library is compiled with the system C++ compiler into the package's
ignored ``_build/`` directory at first use. A failed build raises: there
is no Python fallback coder in the port.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

_DIR = Path(__file__).resolve().parent
_BUILD = _DIR.parent / "_build"
_SOURCES = ("h264_cabac_enc.c", "escape.c")
_DEPS = _SOURCES + ("cabac_engine.h", "cavlc_tables.inc",
                    "h264_cabac_tables.inc", "hevc_tables.inc")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    pass


def _compile() -> Path:
    _BUILD.mkdir(parents=True, exist_ok=True)
    so = _BUILD / "libvt_cabac.so"
    if so.exists() and all(so.stat().st_mtime >= (_DIR / p).stat().st_mtime
                           for p in _DEPS):
        return so
    tmp = _BUILD / f"libvt_cabac.{os.getpid()}.so.tmp"
    cc = os.environ.get("CXX", "g++")
    cmd = [cc, "-O3", "-fPIC", "-shared", "-x", "c++",
           *(str(_DIR / s) for s in _SOURCES), "-I", str(_DIR), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise NativeBuildError(f"cannot run {cc!r}: {exc}") from exc
    if proc.returncode != 0:
        raise NativeBuildError(f"native build failed: {proc.stderr[:2000]}")
    os.replace(tmp, so)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded library (built on first call). Raises on failure."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(_compile()))
        u8 = ctypes.POINTER(ctypes.c_uint8)
        i32 = ctypes.POINTER(ctypes.c_int32)
        lib.vt_escape_emulation.restype = ctypes.c_int64
        lib.vt_escape_emulation.argtypes = [u8, ctypes.c_int64, u8]
        for name in ("vt_h264_cabac_i_slice", "vt_h264_cabac_p_slice"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                i32, i32, i32, i32,                  # level / mv arrays
                ctypes.c_int, ctypes.c_int,          # mbh, mbw
                ctypes.c_int,                        # slice qp
                u8, ctypes.c_int64,                  # header bytes
                i32,                                 # scratch
                u8, ctypes.c_int64,                  # out buffer
            ]
        _LIB = lib
        return _LIB
