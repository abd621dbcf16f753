"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (sm_90a) into
one shared library with a plain C interface, ``build/torch_kernels/
libgan_kernels.so`` at the repository root, and loaded with ``ctypes``. The
library is built at first use and rebuilt when a source is newer than it.
Nothing here runs at import time: a machine without ``nvcc`` imports this
module and only fails if it asks for the library.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

_PKG = Path(__file__).resolve().parents[2]
SOURCES_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
LIB_PATH = BUILD_DIR / "libgan_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    pass


def nvcc_path() -> str:
    """nvcc from PATH, else from the CUDA toolkit torch finds (CUDA_HOME)."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise KernelBuildError("nvcc not found: put it on PATH or set CUDA_HOME")


def build_library() -> Tuple[Path, str]:
    """Compile the kernels if the library is missing or older than a source.
    Returns (library path, compiler output); the output is empty when the
    library was already up to date. Raises KernelBuildError with nvcc's
    stderr when the compiler fails."""
    srcs = sorted(SOURCES_DIR.glob("*.cu"))
    if LIB_PATH.exists() and all(
            s.stat().st_mtime <= LIB_PATH.stat().st_mtime for s in srcs):
        return LIB_PATH, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, LIB_PATH)   # atomic: a concurrent loader sees old or new
    return LIB_PATH, " ".join(cmd) + "\n" + proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with every function's
    argtypes and restype declared. Loaded once per process."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name in ("lgzt_trilinear_fwd", "lgzt_trilinear_bwd"):
        fn = getattr(lib, name)
        # (in, coords, out, B, D, H, W, C, N, stream)
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
    return lib
