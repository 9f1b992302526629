"""Build and load the native entropy coders (ctypes): H.264 CABAC and
CAVLC slice data, HEVC CABAC I and P slice data, NAL emulation
prevention, the JPEG scan packer.

Sources are verbatim copies of the JAX package's C coders:
``h264_cabac_enc.c`` with ``cabac_engine.h``, ``cavlc.c`` (which also
holds ``vt_escape_emulation``), ``hevc_cabac.c`` and ``jpeg_pack.c``. The three ``*.inc``
table headers are committed as generated by
``vlog_tpu/native/gen_tables.py``, ``gen_h264_cabac_tables.py`` and
``gen_hevc_tables.py`` (each file's first line names its generator).

The library is compiled with the system C++ compiler into the build
directory (``parallel/compile_cache.py``: the package's ignored
``_build/`` unless ``VLOG_COMPILE_CACHE_DIR`` is set) at first use. A
failed build raises: there is no Python fallback coder in the port.

The worker-key hash (``argon2.c``: Argon2id, RFC 9106, over BLAKE2b)
is a third library, built the same way by ``get_argon2_lib`` for
``api/auth.py``; it is the port's own code, not a copy.

The libav shim (``avshim.c``, the ingest shim, and ``av1enc.c``, the AV1
encode shim, both copies of the JAX package's, built into one library
as ``vlog_tpu/native/avbuild.py`` builds them) is a second, optional
library: it links the system libavformat, libavcodec, libavutil and
libswscale, and ``get_av_lib`` returns None where they are missing or
``VLOG_LIBAV=0`` disables it, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path

from vlog_tpu_torch.parallel.compile_cache import (ensure_compile_cache,
                                                   note_build)

_DIR = Path(__file__).resolve().parent
_SOURCES = ("h264_cabac_enc.c", "cavlc.c", "hevc_cabac.c", "jpeg_pack.c")
_DEPS = _SOURCES + ("cabac_engine.h", "cavlc_tables.inc",
                    "h264_cabac_tables.inc", "hevc_tables.inc")
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    pass


def _run_compiler(cmd: list[str], what: str, limit: int) -> None:
    """Run one compiler command, metered (parallel/compile_cache.py)."""
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise NativeBuildError(f"cannot run {cmd[0]!r}: {exc}") from exc
    finally:
        note_build(time.perf_counter() - t0)
    if proc.returncode != 0:
        raise NativeBuildError(f"{what} failed: {proc.stderr[:limit]}")


def _compile() -> Path:
    build = Path(ensure_compile_cache())
    so = build / "libvt_native.so"
    if so.exists() and all(so.stat().st_mtime >= (_DIR / p).stat().st_mtime
                           for p in _DEPS):
        return so
    tmp = build / f"libvt_native.{os.getpid()}.so.tmp"
    cc = os.environ.get("CXX", "g++")
    _run_compiler([cc, "-O3", "-fPIC", "-shared", "-x", "c++",
                   '-DVT_HEVC_TABLES_INC="hevc_tables.inc"',
                   *(str(_DIR / s) for s in _SOURCES), "-I", str(_DIR),
                   "-o", str(tmp)], "native build", 2000)
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
        for name in ("vt_cavlc_encode_slice", "vt_cavlc_encode_p_slice"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [
                i32, i32, i32, i32,                  # level / mv arrays
                ctypes.c_int, ctypes.c_int,          # mbh, mbw
                u8, ctypes.c_int64,                  # header bytes
                ctypes.c_uint32, ctypes.c_int,       # header tail bits
                i32,                                 # scratch
                u8, ctypes.c_int64,                  # out buffer
            ]
        u16 = ctypes.POINTER(ctypes.c_uint16)
        lib.vt_jpeg_pack_scan.restype = ctypes.c_int64
        lib.vt_jpeg_pack_scan.argtypes = [
            i32, u8, ctypes.c_int64,                 # blocks, comp, n
            u16, u8, u16, u8, u16, u8, u16, u8,      # 4 Huffman tables
            u8, ctypes.c_int64,                      # out buffer
        ]
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
        i16 = ctypes.POINTER(ctypes.c_int16)
        lib.vt_hevc_encode_slice.restype = ctypes.c_int64
        lib.vt_hevc_encode_slice.argtypes = [
            i16, i16, i16,                           # luma, cb, cr levels
            ctypes.c_int32, ctypes.c_int32,          # rows, cols
            ctypes.c_int32,                          # slice qp
            u8, ctypes.c_int64,                      # out buffer
        ]
        lib.vt_hevc_encode_p_slice.restype = ctypes.c_int64
        lib.vt_hevc_encode_p_slice.argtypes = [
            i16, i16, i16,                           # luma, cb, cr levels
            i32,                                     # mv (y, x) quarter pels
            ctypes.c_int32, ctypes.c_int32,          # rows, cols
            ctypes.c_int32,                          # slice qp
            i32,                                     # mv scratch
            u8, ctypes.c_int64,                      # out buffer
        ]
        _LIB = lib
        return _LIB


class VtAvInfo(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("fps", ctypes.c_double),
        ("duration", ctypes.c_double),
        ("nb_frames", ctypes.c_int64),
        ("has_audio", ctypes.c_int),
        ("vcodec", ctypes.c_char * 32),
        ("acodec", ctypes.c_char * 32),
    ]


_AV_LIB: ctypes.CDLL | None = None
_AV_TRIED = False


def _compile_av() -> Path:
    build = Path(ensure_compile_cache())
    srcs = [_DIR / "avshim.c", _DIR / "av1enc.c"]
    so = build / "libvt_av.so"
    if so.exists() and all(so.stat().st_mtime >= s.stat().st_mtime
                           for s in srcs):
        return so
    tmp = build / f"libvt_av.{os.getpid()}.so.tmp"
    cc = os.environ.get("CC", "gcc")
    _run_compiler([cc, "-O2", "-fPIC", "-shared", *map(str, srcs), "-o",
                   str(tmp), "-lavformat", "-lavcodec", "-lavutil",
                   "-lswscale"], "avshim build", 1000)
    os.replace(tmp, so)
    return so


def get_av_lib() -> ctypes.CDLL | None:
    """The loaded libav ingest shim, or None (unavailable or disabled)."""
    global _AV_LIB, _AV_TRIED
    if os.environ.get("VLOG_LIBAV", "1") in ("0", "false", "no"):
        return None
    with _LOCK:
        if _AV_TRIED:
            return _AV_LIB
        _AV_TRIED = True
        try:
            lib = ctypes.CDLL(str(_compile_av()))
        except (NativeBuildError, OSError):
            return None
        u8 = ctypes.POINTER(ctypes.c_uint8)
        lib.vt_av_open.restype = ctypes.c_void_p
        lib.vt_av_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(VtAvInfo)]
        lib.vt_av_read.restype = ctypes.c_int64
        lib.vt_av_read.argtypes = [ctypes.c_void_p, u8, ctypes.c_int64]
        lib.vt_av_read_pts.restype = ctypes.c_int64
        lib.vt_av_read_pts.argtypes = [ctypes.c_void_p, u8,
                                       ctypes.POINTER(ctypes.c_double),
                                       ctypes.c_int64]
        lib.vt_av_seek.restype = ctypes.c_int
        lib.vt_av_seek.argtypes = [ctypes.c_void_p, ctypes.c_double]
        lib.vt_av_close.restype = None
        lib.vt_av_close.argtypes = [ctypes.c_void_p]
        lib.vt_av_audio_to_f32.restype = ctypes.c_int64
        lib.vt_av_audio_to_f32.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.vt_av1_open.restype = ctypes.c_void_p
        lib.vt_av1_open.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_int]
        lib.vt_av1_send.restype = ctypes.c_int
        lib.vt_av1_send.argtypes = [ctypes.c_void_p, u8, u8, u8, ctypes.c_int]
        lib.vt_av1_flush.restype = ctypes.c_int
        lib.vt_av1_flush.argtypes = [ctypes.c_void_p]
        lib.vt_av1_receive.restype = ctypes.c_int64
        lib.vt_av1_receive.argtypes = [
            ctypes.c_void_p, u8, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64)]
        lib.vt_av1_close.restype = None
        lib.vt_av1_close.argtypes = [ctypes.c_void_p]
        _AV_LIB = lib
        return _AV_LIB


_ARGON2_LIB: ctypes.CDLL | None = None


def _compile_argon2() -> Path:
    build = Path(ensure_compile_cache())
    src = _DIR / "argon2.c"
    so = build / "libvt_argon2.so"
    if so.exists() and so.stat().st_mtime >= src.stat().st_mtime:
        return so
    tmp = build / f"libvt_argon2.{os.getpid()}.so.tmp"
    cc = os.environ.get("CC", "gcc")
    _run_compiler([cc, "-O2", "-fPIC", "-shared", str(src), "-o", str(tmp)],
                  "argon2 build", 1000)
    os.replace(tmp, so)
    return so


def get_argon2_lib() -> ctypes.CDLL:
    """The loaded Argon2id library (built on first call). Raises on
    failure: the port has no other hash for worker keys."""
    global _ARGON2_LIB
    with _LOCK:
        if _ARGON2_LIB is not None:
            return _ARGON2_LIB
        lib = ctypes.CDLL(str(_compile_argon2()))
        u8, u32 = ctypes.c_char_p, ctypes.c_uint32
        lib.vt_argon2id.restype = ctypes.c_int
        lib.vt_argon2id.argtypes = [
            u8, u32, u8, u32, u8, u32, u8, u32,      # pwd, salt, secret, ad
            u32, u32, u32,                           # t, m (KiB), lanes
            ctypes.c_void_p, u32,                    # out, outlen
        ]
        _ARGON2_LIB = lib
        return _ARGON2_LIB
