"""Build the CUDA kernels at first use and load them with ``ctypes``.

The sources under ``repro_torch/csrc/`` have a plain C interface, so
``nvcc`` compiles them straight into a shared library (no PyTorch
headers, a few seconds).  The library lands in ``build/repro_torch/`` at
the root of the checkout, named by a hash of the sources and the flags:
a changed source builds anew, an unchanged one loads what is there.
Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "flexvector_spmm.cu",)
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB: Optional[ctypes.CDLL] = None
#: Seconds the last :func:`load_library` spent compiling (0.0 if cached).
BUILD_SECONDS = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of repro_torch are compiled at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libflexvector_spmm-{h.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def load_library() -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library, once per process."""
    global _LIB, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    lib = library_path()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)],
                capture_output=True, text=True,
            )
            build_log_path().write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
                )
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        BUILD_SECONDS = time.perf_counter() - t0
    _LIB = ctypes.CDLL(str(lib))
    return _LIB
