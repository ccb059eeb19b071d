"""ctypes bindings for the host image decoder (``loader.cc``): a batch of JPEG
or PNG files decoded, centre-cropped and resized in parallel in C++.

The library is compiled with g++ at first use, never at import, into
``blurred_gan_tpu_torch/_build/`` (git-ignored), keyed by a hash of the source
and the flags. It needs libjpeg's and libpng's headers and libraries; where
they are missing the build fails, :func:`available` is false and
:func:`build_error` says why, and callers keep a path without it (the image
folder dataset decodes with Pillow then).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parent / "loader.cc"
BUILD_DIR = SOURCE.parent.parent / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-pthread"]
LIBS = ["-ljpeg", "-lpng"]

# The prefetch thread and ``materialize`` may reach the first build together.
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def build() -> Path:
    """Compile ``loader.cc`` (if not already built) and return the shared
    library's path. Raises ``RuntimeError`` if g++ is missing or fails, with
    what the compiler said on one line."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"loader-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # One temporary file per process: several processes may build at once.
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"g++ not found; the native image loader needs it ({e})") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        said = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines() if ln.strip()]
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' | '.join(said)}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and bound once per process; ``None`` (with
    :func:`build_error` set) if it cannot be built or loaded."""
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
            return None
        lib.bgt_decode_batch.restype = ctypes.c_int
        lib.bgt_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.bgt_gather_batch.restype = None
        lib.bgt_gather_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native image loader unavailable: {_build_error}")
    return lib


def decode_batch(paths: Sequence[str], resolution: int,
                 n_threads: Optional[int] = None) -> np.ndarray:
    """Decode image files to ``(N, resolution, resolution, 3)`` uint8, in
    parallel (``min(cpu_count, N, 32)`` threads by default). Raises
    ``IOError`` naming the first file that does not decode."""
    lib = _require()
    n = len(paths)
    out = np.empty((n, resolution, resolution, 3), np.uint8)
    if n == 0:
        return out
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    threads = n_threads or min(os.cpu_count() or 1, n, 32)
    rc = lib.bgt_decode_batch(arr, n, resolution,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), threads)
    if rc != 0:
        raise IOError(f"failed to decode image: {paths[rc - 1]}")
    return out


def gather_batch(src: np.ndarray, indices: np.ndarray,
                 n_threads: Optional[int] = None) -> np.ndarray:
    """``src[indices]`` for a C-contiguous uint8 array, one parallel row
    ``memcpy`` per index."""
    lib = _require()
    if src.dtype != np.uint8 or not src.flags.c_contiguous:
        raise ValueError(f"expected a C-contiguous uint8 array, got {src.dtype}")
    idx = np.ascontiguousarray(indices, np.int64)
    if idx.ndim != 1 or (idx.size and (idx.min() < 0 or idx.max() >= src.shape[0])):
        raise IndexError(f"indices out of range for {src.shape[0]} rows")
    n = idx.shape[0]
    item_bytes = int(src.nbytes // src.shape[0])
    out = np.empty((n,) + src.shape[1:], np.uint8)
    threads = n_threads or min(os.cpu_count() or 1, 16)
    lib.bgt_gather_batch(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, item_bytes, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), threads)
    return out
