"""Build, load and count the hand-written CUDA kernels.

Each source file in ``csrc/`` has a plain C interface: one entry point per
kernel (K3 and K4 share ``conv_transpose3d.cu``; K5's and K6's sources
each hold a forward and a backward entry). At first use it is compiled
with ``nvcc`` for ``sm_90a`` into a shared library under
``build/torch_kernels/`` (named by a digest of the source, so an edited
source is rebuilt) and loaded with ``ctypes``. :func:`build` compiles several
sources at once, one ``nvcc`` process each, all started together.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0, so a refused launch never passes
silently. Every wrapper adds one to :data:`launch_counts` under its
kernel's name each time it launches, and nowhere else, and opens a
``pds.kernel.<name>`` span (``utils/profiling.py::span``) under that name
around the launch, with :func:`launch_args`. A 3-D conv that takes the
stock PyTorch conv instead of a hand kernel (``models/blocks.py``) adds one
to :data:`fallback_counts` under its op and geometry
(:func:`count_fallback`), on any device.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_ROOT = Path(__file__).resolve().parent.parent
SOURCE_DIRECTORY = PACKAGE_ROOT / "csrc"
BUILD_DIRECTORY = PACKAGE_ROOT.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_NAMES = ("conv3d_k3s1", "subpixel_map", "conv_transpose3d",
                "block_norm", "batch_norm")

# Launches per kernel name since the last ``launch_counts.clear()``.
launch_counts: collections.Counter = collections.Counter()
# 3-D conv calls that left the hand kernels, per op and geometry, since the
# last ``fallback_counts.clear()``.
fallback_counts: collections.Counter = collections.Counter()
# ptxas report (registers, shared memory, spills) of each build in this
# process, by kernel name.
build_reports: dict[str, str] = {}

_libraries: dict[str, ctypes.CDLL] = {}
_entries: set[tuple[str, str]] = set()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                       "kernels are compiled at first use and need it")


def _source(name: str) -> Path:
    return SOURCE_DIRECTORY / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256(_source(name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIRECTORY / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNEL_NAMES) -> float:
    """Compiles every named kernel whose library is missing, all ``nvcc``
    processes at once. Returns the wall seconds spent; raises with the
    compiler's output if any build fails."""
    start = time.perf_counter()
    BUILD_DIRECTORY.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        temporary = target.with_suffix(f".{os.getpid()}.tmp")
        command = [_nvcc(), *NVCC_FLAGS, "-o", str(temporary),
                   str(_source(name))]
        running[name] = (subprocess.Popen(
            command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), temporary, target)
    failures = []
    for name, (process, temporary, target) in running.items():
        output, _ = process.communicate()
        build_reports[name] = output
        if process.returncode != 0:
            failures.append(f"{name}: nvcc exited {process.returncode}\n"
                            f"{output}")
            continue
        os.replace(temporary, target)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - start


def library(name: str, signature: list, entry: str | None = None
            ) -> ctypes.CDLL:
    """Returns the loaded library built from ``csrc/<name>.cu``, building it
    first if needed. ``signature`` is the ``argtypes`` list of its C entry
    point ``entry`` (by default the source's name), which returns a CUDA
    error code; ``<name>_error_string`` names such a code."""
    if name not in _libraries:
        build([name])
        loaded = ctypes.CDLL(str(library_path(name)))
        error_string = getattr(loaded, f"{name}_error_string")
        error_string.argtypes = [ctypes.c_int]
        error_string.restype = ctypes.c_char_p
        _libraries[name] = loaded
    entry = entry or name
    if (name, entry) not in _entries:
        function = getattr(_libraries[name], entry)
        function.argtypes = signature
        function.restype = ctypes.c_int
        _entries.add((name, entry))
    return _libraries[name]


def launch_args(volume, weight=None) -> str:
    """What a kernel span records of its launch: the input's shape, the
    weight's and the dtype."""
    weight_shape = None if weight is None else tuple(weight.shape)
    return (f"input {tuple(volume.shape)}, weight {weight_shape}, "
            f"{volume.dtype}")


def count_fallback(op: str, kernel_size, stride, channels) -> None:
    """Counts one call of ``op`` that took the stock PyTorch conv, under
    ``"<op> k<kernel> s<stride> <cin>-><cout>"``, e.g. ``"conv3d k3x3x3
    s2x2x2 32->64"``."""
    fallback_counts[f"{op} k{'x'.join(map(str, kernel_size))} "
                    f"s{'x'.join(map(str, stride))} "
                    f"{channels[0]}->{channels[1]}"] += 1


def check(name: str, status: int) -> None:
    """Raises if a C entry point reported a CUDA error for its launch."""
    if status != 0:
        message = getattr(_libraries[name], f"{name}_error_string")(status)
        raise RuntimeError(f"{name} launch failed: CUDA error {status} "
                           f"({message.decode()})")
