"""ctypes binding of the parallel ``.npy`` feature loader (``npy_loader.cpp``;
counterpart of ``hual_tpu/native``).

The library is compiled with g++ at first use into
``build/hual_tpu_torch/libnpy_loader-<digest>.so`` at the repository root,
where the digest covers the source and the flags, as the CUDA kernels are
(``ops/kernels/build.py``); nothing is built at import.  A file the loader
cannot parse gets a nonzero status and is read by the NumPy path
(``data/features.FeatureStore.from_dir``).  When the library cannot be
built or loaded, a warning names the cause and :func:`load_npy_batch`
returns None; :func:`error` keeps the cause.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from hual_tpu_torch.ops.kernels.build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "npy_loader.cpp"
GXX = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_log = logging.getLogger(__name__)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libnpy_loader-{digest[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([GXX, *FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{GXX} exited {proc.returncode}: "
                           f"{(proc.stderr or proc.stdout).strip()[-2000:]}")
    os.replace(tmp, out)        # atomic: a concurrent loader sees all or none
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None (with a warning that
    names the cause) when it cannot be built or loaded."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                lib = ctypes.CDLL(str(_build()))
                lib.hual_load_npy_batch.restype = ctypes.c_int64
                lib.hual_load_npy_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_int32,
                ]
                _lib = lib
            except (OSError, RuntimeError, AttributeError) as e:
                _error = f"{type(e).__name__}: {e}"
                _log.warning("the native npy loader is unavailable (%s)", _error)
        return _lib


def error() -> Optional[str]:
    """Why the library could not be built or loaded, or None."""
    return _error


def load_npy_batch(paths: list[str], max_vlen: int, vdim: int,
                   n_threads: int = 0
                   ) -> Optional[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Load and downsample many ``.npy`` files into one packed block.

    Returns (packed (n, max_vlen, vdim) f32, lengths (n,) i64, statuses (n,)
    i32, nonzero where the NumPy path must read the file), or None if the
    library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    packed = np.zeros((n, max_vlen, vdim), dtype=np.float32)
    lengths = np.zeros((n,), dtype=np.int64)
    statuses = np.zeros((n,), dtype=np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.hual_load_npy_batch(
        c_paths, n,
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        max_vlen, vdim, n_threads)
    return packed, lengths, statuses
