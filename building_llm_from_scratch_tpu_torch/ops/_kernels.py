"""Builds and loads the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``. The library is
built at first use into ``_build/`` beside the package (listed in
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    """The compiled sources (one object each)."""
    return sorted(CSRC.glob("*.cu"))


def headers() -> list:
    """The headers the sources include (hashed with them)."""
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc): the kernels are "
                           "built on a machine with the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
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
    nvcc = _nvcc()
    tag = f"{path.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources(), objs)]
    outs = [p.communicate()[0] for p in procs]
    log = "".join(outs)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    failed = [src.name for src, p in zip(sources(), procs) if p.returncode]
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode:
            failed = ["link"]
    seconds = time.perf_counter() - t0
    (BUILD_DIR / "build.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log[-4000:]}")
    os.replace(tmp, path)        # atomic: a concurrent loader sees all or nothing
    return dict(path=str(path), built=True, seconds=seconds, log=log)


def load_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            i32, u32, f32, ptr = (ctypes.c_int, ctypes.c_uint32, ctypes.c_float,
                                  ctypes.c_void_p)
            lib.bllm_fused_decode_step.argtypes = [i32] * 6 + [ptr] * 8
            # dtype, hd, B, T, Hq, Hkv, scale, threshold, 1/(1-p), seed words
            head = [i32] * 6 + [f32, u32, f32, u32, u32]
            lib.bllm_attn_fwd.argtypes = head + [ptr] * 6
            lib.bllm_attn_bwd_dq.argtypes = head + [ptr] * 8
            lib.bllm_attn_bwd_dkv.argtypes = head + [ptr] * 9
            lib.bllm_dropout.argtypes = [i32, ctypes.c_longlong, u32, f32, u32, u32] + [ptr] * 4
            lib.bllm_xent_fwd.argtypes = [i32] * 5 + [ptr] * 9
            for name in ("bllm_fused_decode_step", "bllm_attn_fwd", "bllm_attn_bwd_dq",
                         "bllm_attn_bwd_dkv", "bllm_dropout", "bllm_xent_fwd"):
                getattr(lib, name).restype = i32
            lib.bllm_error_string.argtypes = [ctypes.c_int]
            lib.bllm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
