"""The native PFM reader and disparity-statistics scanner (C++, ctypes).

Port of ``practicaldeepstereo_nips2018_tpu/data/native.py`` over the
package's own copy of its source, ``csrc/pfm_stats.cpp``: a PFM decode and
a scan of many PFMs in C++ worker threads (integer minimum and maximum, and
the 512-bin cumulative distribution ``data/flyingthings3d.py`` computes).

At first use the source is compiled with ``g++`` into a shared library
under ``build/native/`` (named by a digest of the source and the flags, so
an edited source is rebuilt), as ``ops/kernels.py`` builds the CUDA
kernels. Unlike the JAX package's, nothing falls back to numpy: a failed
build raises with the compiler's output (``find_examples(...,
use_native_scanner=False)`` is the Python path).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PACKAGE_ROOT = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_ROOT / "csrc" / "pfm_stats.cpp"
BUILD_DIRECTORY = PACKAGE_ROOT.parent / "build" / "native"
COMPILER = "g++"
COMPILER_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
CUMULATIVE_BINS = 512

_lock = threading.Lock()
_libraries: dict[Path, ctypes.CDLL] = {}


def library_path() -> Path:
    """Where the library built from :data:`SOURCE` lives."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(COMPILER_FLAGS).encode())
    return BUILD_DIRECTORY / f"libpds_pfm_stats-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compiles the library unless it is there; returns its path. Raises
    with the compiler's output if the build fails."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIRECTORY.mkdir(parents=True, exist_ok=True)
    temporary = target.with_suffix(f".{os.getpid()}.tmp")
    command = [COMPILER, *COMPILER_FLAGS, str(SOURCE), "-o", str(temporary)]
    try:
        result = subprocess.run(command, capture_output=True, text=True,
                                timeout=300)
    except (OSError, subprocess.TimeoutExpired) as error:
        raise RuntimeError(f"native PFM library build failed: {command}: "
                           f"{error}") from error
    if result.returncode != 0:
        raise RuntimeError(
            f"native PFM library build failed: {COMPILER} exited "
            f"{result.returncode}\n{result.stdout}{result.stderr}")
    os.replace(temporary, target)
    return target


def load_library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    with _lock:
        path = build()
        if path not in _libraries:
            library = ctypes.CDLL(str(path))
            library.pds_read_pfm.restype = ctypes.c_int
            library.pds_read_pfm.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            library.pds_scan_disparity_statistics.restype = ctypes.c_int
            library.pds_scan_disparity_statistics.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)]
            _libraries[path] = library
        return _libraries[path]


def _floats(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_pfm(path: str, max_pixels: int = 8192 * 8192) -> np.ndarray:
    """Reads a PFM into ``[H, W]`` or ``[H, W, 3]`` float32, as
    ``data/pfm.py::read_pfm`` does. Raises ValueError for a file it cannot
    parse or one of more than ``max_pixels`` values."""
    library = load_library()
    buffer = np.empty(max_pixels, dtype=np.float32)
    height, width, channels = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    status = library.pds_read_pfm(
        path.encode("utf-8"), _floats(buffer), buffer.size,
        ctypes.byref(height), ctypes.byref(width), ctypes.byref(channels))
    if status != 0:
        raise ValueError(f"native PFM read failed ({status}): {path}")
    shape = ((height.value, width.value) if channels.value == 1 else
             (height.value, width.value, channels.value))
    return buffer[:int(np.prod(shape))].reshape(shape).copy()


def scan_disparity_statistics(paths: list[str], threads: int | None = None):
    """Scans ``paths`` in ``threads`` C++ threads (default: twice the
    CPUs, at most 16). Returns float32 ``minimums [N]``, ``maximums [N]``
    (the floor and ceiling of each image's values), ``cumulatives [N,
    512]`` (percent) and int32 ``status [N]``: 0, or -1 for a file that
    could not be read, whose other entries are undefined."""
    library = load_library()
    if threads is None:
        threads = min(16, (os.cpu_count() or 2) * 2)
    count = len(paths)
    encoded = [path.encode("utf-8") for path in paths]
    path_array = (ctypes.c_char_p * count)(*encoded)
    minimums = np.empty(count, np.float32)
    maximums = np.empty(count, np.float32)
    cumulatives = np.empty((count, CUMULATIVE_BINS), np.float32)
    status = np.empty(count, np.int32)
    library.pds_scan_disparity_statistics(
        path_array, count, threads, _floats(minimums), _floats(maximums),
        _floats(cumulatives),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    return minimums, maximums, cumulatives, status
