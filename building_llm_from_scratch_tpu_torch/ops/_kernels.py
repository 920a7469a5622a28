"""Builds and loads the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``. The library
is built at first use into ``_build/`` beside the package (listed in
``.gitignore``) and named by a hash of the sources, so an edited source is
rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc): the kernels are "
                           "built on a machine with the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libbllm_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the library unless the one for the current sources exists.
    Returns {"path", "built", "seconds", "log"} (nvcc's output, with
    ``-Xptxas -v`` register and spill counts)."""
    path = library_path()
    if path.exists():
        return dict(path=str(path), built=False, seconds=0.0, log="")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = res.stdout + res.stderr
    (BUILD_DIR / "build.log").write_text(" ".join(cmd) + "\n" + log)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{log[-4000:]}")
    os.replace(tmp, path)        # atomic: a concurrent loader sees all or nothing
    return dict(path=str(path), built=True, seconds=seconds, log=log)


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            f = lib.bllm_fused_decode_step
            f.argtypes = ([ctypes.c_int] * 6) + [ctypes.c_void_p] * 8
            f.restype = ctypes.c_int
            lib.bllm_error_string.argtypes = [ctypes.c_int]
            lib.bllm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
