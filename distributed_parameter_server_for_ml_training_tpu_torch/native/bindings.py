"""ctypes bindings for the C++ parameter arena (``native/ps_core.cpp``).

The JAX package's ``native/bindings.py``, carried over with one change in
how the library is found: the port builds it from the repo's
``native/ps_core.cpp`` at first use, with ``native/Makefile``'s flags,
into ``build/torch_native/libps_core.so`` at the root of the checkout
(listed in ``.gitignore``). It never runs ``make`` in ``native/``, which
would rewrite the library tracked there, and never loads that library.
A stamp beside the output records a hash of the source and the flags, so
an edited source is rebuilt. ``DPS_NATIVE_LIB`` names a prebuilt library
to load instead. A library that lacks one of :data:`_REQUIRED_SYMBOLS` is
stale and is not bound. A failed build raises, naming the compiler's
error: nothing falls back to the NumPy store or to the NumPy casts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_LIB = None
_LIB_LOCK = threading.Lock()

REPO = Path(__file__).resolve().parents[2]
SOURCE = REPO / "native" / "ps_core.cpp"
BUILD_DIR = REPO / "build" / "torch_native"
LIBRARY = BUILD_DIR / "libps_core.so"
_STAMP = BUILD_DIR / "libps_core.so.sha256"

#: ``native/Makefile``'s ``CXXFLAGS`` and its ``-shared``.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

# Every symbol the bindings below resolve; _stale() probes these directly.
_REQUIRED_SYMBOLS = (
    "dps_fp32_to_fp16", "dps_fp16_to_fp32",
    "dps_fp32_to_bf16", "dps_bf16_to_fp32",
    "dps_store_create", "dps_store_destroy", "dps_store_step",
    "dps_store_rejected", "dps_store_fetch", "dps_store_load",
    "dps_store_push_fp16", "dps_store_push_fp32", "dps_store_push_int8",
    "dps_store_stash_fp16", "dps_store_stash_fp32", "dps_store_stash_int8",
    "dps_store_apply_mean", "dps_store_free_slot",
)


def _compiler() -> str:
    """``$CXX``, else ``g++`` as ``native/Makefile`` defaults."""
    return os.environ.get("CXX") or shutil.which("g++") or "g++"


def _digest() -> str:
    return hashlib.sha256(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()


def build() -> Path:
    """Compile ``native/ps_core.cpp`` into :data:`LIBRARY` unless the
    library built from this exact source is there and complete. The
    compiler writes a temporary file that is then renamed into place, so
    processes building at once never see a partial library. Raises
    ``RuntimeError`` with the compiler's output when the build fails."""
    digest = _digest()
    if LIBRARY.exists() and _STAMP.exists() \
            and _STAMP.read_text().strip() == digest \
            and not _stale(str(LIBRARY)):
        return LIBRARY
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_compiler(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"building the C++ arena failed: "
                               f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the C++ arena failed (rc {proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, LIBRARY)
        fd, stamp_tmp = tempfile.mkstemp(dir=BUILD_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(digest)
        os.replace(stamp_tmp, _STAMP)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return LIBRARY


def _stale(so: str) -> bool:
    """True when the library doesn't export every symbol these bindings
    need (it predates the current source). The probe handle is released
    before returning: dlopen dedups by pathname, so a still-open stale
    mapping would be what a later load of a rebuilt library at the same
    path returns."""
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return True
    try:
        return any(not hasattr(lib, sym) for sym in _REQUIRED_SYMBOLS)
    finally:
        try:
            import _ctypes

            _ctypes.dlclose(lib._handle)
        except (AttributeError, OSError):
            pass


def library_path() -> Path:
    """The library to load: ``DPS_NATIVE_LIB`` when it names one, else
    the one built from the checkout's source (built now if needed)."""
    override = os.environ.get("DPS_NATIVE_LIB", "")
    if override:
        if not os.path.isfile(override) or _stale(override):
            raise RuntimeError(
                f"DPS_NATIVE_LIB={override!r} is missing or lacks the "
                f"arena's symbols ({', '.join(_REQUIRED_SYMBOLS)})")
        return Path(override)
    return build()


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the arena library and declare its
    signatures. Raises ``RuntimeError`` when it cannot be built."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(library_path()))

        u16p = ctypes.POINTER(ctypes.c_uint16)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.c_int64

        lib.dps_fp32_to_fp16.argtypes = [f32p, u16p, i64]
        lib.dps_fp16_to_fp32.argtypes = [u16p, f32p, i64]
        lib.dps_fp32_to_bf16.argtypes = [f32p, u16p, i64]
        lib.dps_bf16_to_fp32.argtypes = [u16p, f32p, i64]
        lib.dps_store_create.argtypes = [i64, f32p, ctypes.c_float]
        lib.dps_store_create.restype = ctypes.c_void_p
        lib.dps_store_destroy.argtypes = [ctypes.c_void_p]
        lib.dps_store_step.argtypes = [ctypes.c_void_p]
        lib.dps_store_step.restype = i64
        lib.dps_store_rejected.argtypes = [ctypes.c_void_p]
        lib.dps_store_rejected.restype = i64
        lib.dps_store_fetch.argtypes = [ctypes.c_void_p, f32p]
        lib.dps_store_fetch.restype = i64
        lib.dps_store_load.argtypes = [ctypes.c_void_p, f32p, i64]
        lib.dps_store_push_fp16.argtypes = [ctypes.c_void_p, u16p, i64, i64]
        lib.dps_store_push_fp16.restype = i64
        lib.dps_store_push_fp32.argtypes = [ctypes.c_void_p, f32p, i64, i64]
        lib.dps_store_push_fp32.restype = i64
        i64p = ctypes.POINTER(i64)
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.dps_store_push_int8.argtypes = [
            ctypes.c_void_p, i8p, f32p, i64p, i64, i64, i64]
        lib.dps_store_push_int8.restype = i64
        lib.dps_store_stash_fp16.argtypes = [ctypes.c_void_p, i64, u16p]
        lib.dps_store_stash_fp32.argtypes = [ctypes.c_void_p, i64, f32p]
        lib.dps_store_stash_int8.argtypes = [
            ctypes.c_void_p, i64, i8p, f32p, i64p, i64]
        lib.dps_store_apply_mean.argtypes = [ctypes.c_void_p, i64p, i64]
        lib.dps_store_apply_mean.restype = i64
        lib.dps_store_free_slot.argtypes = [ctypes.c_void_p, i64]
        _LIB = lib
        return _LIB


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u16p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def _i8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def fp32_to_fp16(src: np.ndarray) -> np.ndarray:
    """Multithreaded fp32 -> fp16 cast (round to nearest even, as
    NumPy's ``astype``)."""
    lib = load_library()
    src = np.ascontiguousarray(src, np.float32)
    out = np.empty(src.shape, np.uint16)
    lib.dps_fp32_to_fp16(_f32p(src.reshape(-1)), _u16p(out.reshape(-1)),
                         src.size)
    return out.view(np.float16)


def fp16_to_fp32(src: np.ndarray) -> np.ndarray:
    lib = load_library()
    src = np.ascontiguousarray(src)
    if src.dtype != np.float16:
        raise TypeError(src.dtype)
    out = np.empty(src.shape, np.float32)
    lib.dps_fp16_to_fp32(_u16p(src.view(np.uint16).reshape(-1)),
                         _f32p(out.reshape(-1)), src.size)
    return out


def fp32_to_bf16(src: np.ndarray) -> np.ndarray:
    """Multithreaded fp32 -> bfloat16 cast (round to nearest even, bit for
    bit ``ml_dtypes``) for the fetch-side codec."""
    import ml_dtypes

    lib = load_library()
    src = np.ascontiguousarray(src, np.float32)
    out = np.empty(src.shape, np.uint16)
    lib.dps_fp32_to_bf16(_f32p(src.reshape(-1)), _u16p(out.reshape(-1)),
                         src.size)
    return out.view(ml_dtypes.bfloat16)


def bf16_to_fp32(src: np.ndarray) -> np.ndarray:
    import ml_dtypes

    lib = load_library()
    src = np.ascontiguousarray(src)
    if src.dtype != ml_dtypes.bfloat16:
        raise TypeError(src.dtype)
    out = np.empty(src.shape, np.float32)
    lib.dps_bf16_to_fp32(_u16p(src.view(np.uint16).reshape(-1)),
                         _f32p(out.reshape(-1)), src.size)
    return out
