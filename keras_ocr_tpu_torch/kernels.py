"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under
``<checkout>/build/kernels/``, named by a hash of its source so an edited
kernel rebuilds, and loaded with :mod:`ctypes`. The build happens at the
first launch, never at import, so the CPU-only test environment imports
every module without a compiler.

The kernels reach PyTorch as operators of one namespace,
``torch.ops.keras_ocr_tpu_torch`` (:data:`LIBRARY`): each op module defines
its ops there with a CPU kernel (the plain PyTorch version), a CUDA kernel
(the launch, which raises on failure) and a fake kernel (output shapes only),
so that ``torch.export`` records a launch as one opaque node and a loaded
program dispatches it by device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

NAMESPACE = "keras_ocr_tpu_torch"
LIBRARY = torch.library.Library(NAMESPACE, "DEF")

_PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_source_locks: dict = {}
_loaded: dict = {}


def find_nvcc() -> str:
    """``nvcc`` from ``CUDA_HOME``, then ``/usr/local/cuda/bin``, then PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built"
        )
    return found


def library_path(source_name: str) -> str:
    """Where the shared library for ``csrc/<source_name>`` is built."""
    source = os.path.join(SOURCE_DIR, source_name)
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(source_name)[0]
    return os.path.join(BUILD_DIR, f"{stem}_{digest[:16]}.so")


def load(source_name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source_name>``; cached per process.
    Different sources build concurrently when loaded from several threads."""
    with _lock:
        source_lock = _source_locks.setdefault(source_name, threading.Lock())
    with source_lock:
        lib = _loaded.get(source_name)
        if lib is not None:
            return lib
        path = library_path(source_name)
        if not os.path.isfile(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            # Build to a private name, then rename: concurrent builds
            # never load a half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                     os.path.join(SOURCE_DIR, source_name)],
                    capture_output=True, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {source_name} (exit "
                        f"{proc.returncode}):\n{proc.stderr}"
                    )
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        lib = ctypes.CDLL(path)
        _loaded[source_name] = lib
        return lib
