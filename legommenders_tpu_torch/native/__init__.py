"""Native (C) host-side helpers of the batch pipeline, loaded via ctypes.

The port's copy of the JAX package's native/, as far as the port uses it:
`neg_sampler.c` (partial Fisher-Yates negative sampling) is built on demand
with the system C compiler into `legommenders_tpu_torch/_build/` (listed
in .gitignore), never beside the source. These are host helpers, not
device kernels: where no C compiler is available the callers take their
numpy path, and `backend()` says which one runs.
"""
import ctypes
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "neg_sampler.c")
BUILD = os.path.join(os.path.dirname(_HERE), "_build")
_LIB = os.path.join(BUILD, "libnegsampler.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Compile into a temporary file and rename it into place, so that
    processes building at once never load a half-written library."""
    os.makedirs(BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        subprocess.run(
            ["cc", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
             "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception:
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.isfile(_LIB) or (
            os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_LIB)
    except OSError:
        return None
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.sample_negatives.argtypes = [
        i32p, i32p, i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_uint64, i32p, i32p]
    lib.sample_negatives.restype = None
    _lib = lib
    return _lib


def backend() -> str:
    """"c" when the native library builds and loads here, else "numpy"."""
    return "c" if get_lib() is not None else "numpy"


def sample_negatives(negs: np.ndarray, counts: np.ndarray,
                     users: np.ndarray, K: int, num_items: int,
                     seed: int) -> Optional[np.ndarray]:
    """Returns (B, K) int32 or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    B, M = len(users), negs.shape[1]
    out = np.empty((B, K), np.int32)
    scratch = np.empty(max(M, 1), np.int32)
    lib.sample_negatives(
        np.ascontiguousarray(negs, np.int32),
        np.ascontiguousarray(counts, np.int32),
        np.ascontiguousarray(users, np.int64),
        B, M, K, num_items, seed & 0xFFFFFFFFFFFFFFFF, out, scratch)
    return out
