"""Build and load the port's CUDA kernels.

Each kernel source (``ops/csrc/*.cu``) has a plain C interface. At first
use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library in
the port's build directory (rebuilt when the source, or any header under
``csrc/`` it may include, is newer) and loaded with ctypes. Libraries
build independently, so two threads can run two ``nvcc`` processes side
by side. ``build_logs`` keeps what ``ptxas -v`` said of each build
(registers, shared memory and spills per kernel).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict

from photon_ml_tpu_torch.utils.device import build_dir

CSRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc"
)

_GUARD = threading.Lock()
_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def compile_library(source_name: str, lib_path: str) -> None:
    """``nvcc`` ``csrc/<source_name>`` into ``lib_path``; raises when it
    fails."""
    source = os.path.join(CSRC, source_name)
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    # temp path + atomic rename: another process never loads a half-written
    # library
    tmp_path = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
        "-o", tmp_path, source,
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {os.path.basename(source)} "
            f"({proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp_path, lib_path)
    build_logs[source_name] = proc.stderr


def _sources_mtime(source_name: str) -> float:
    """Newest modification time of the source and the headers beside it."""
    paths = [os.path.join(CSRC, source_name)] + [
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh")
    ]
    return max(os.path.getmtime(p) for p in paths)


def load_kernel_library(
    source_name: str, declare: Callable[[ctypes.CDLL], None]
) -> ctypes.CDLL:
    """``csrc/<source_name>`` as a loaded library; ``declare`` sets its
    functions' ``argtypes``/``restype`` once. Raises when ``nvcc`` fails."""
    lib = _libs.get(source_name)
    if lib is not None:
        return lib
    with _GUARD:
        lock = _locks.setdefault(source_name, threading.Lock())
    with lock:
        if source_name not in _libs:
            stem = os.path.splitext(source_name)[0]
            lib_path = os.path.join(build_dir(), f"lib{stem}.so")
            if not (
                os.path.isfile(lib_path)
                and os.path.getmtime(lib_path) >= _sources_mtime(source_name)
            ):
                compile_library(source_name, lib_path)
            lib = ctypes.CDLL(lib_path)
            declare(lib)
            _libs[source_name] = lib
    return _libs[source_name]


def timed_build(load: Callable[[], object]) -> float:
    """Run a kernel's loader; -> seconds spent (the build, when stale)."""
    t0 = time.perf_counter()
    load()
    return time.perf_counter() - t0
