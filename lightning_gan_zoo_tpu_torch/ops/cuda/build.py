"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (sm_90a), one
``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface,
``build/torch_kernels/libgan_kernels.so`` at the repository root, loaded
with ``ctypes``. The library is built at first use and rebuilt when a source
or a header (``csrc/*.cuh``) is newer than it. Nothing here runs at import time: a machine without
``nvcc`` imports this module and only fails if it asks for the library.
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

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17"]
COMPILE_FLAGS = [*ARCH_FLAGS, "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                 "-c"]
LINK_FLAGS = [*ARCH_FLAGS, "-shared"]


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


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    return " ".join(cmd) + "\n" + proc.stdout + proc.stderr


def build_library() -> Tuple[Path, str]:
    """Compile the kernels if the library is missing or older than a source
    or a header.
    Returns (library path, compiler output); the output is empty when the
    library was already up to date. Raises KernelBuildError with nvcc's
    stderr when the compiler fails."""
    srcs = sorted(SOURCES_DIR.glob("*.cu"))
    inputs = [*srcs, *SOURCES_DIR.glob("*.cuh")]
    if LIB_PATH.exists() and all(
            s.stat().st_mtime <= LIB_PATH.stat().st_mtime for s in inputs):
        return LIB_PATH, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = nvcc_path()
    objs = [BUILD_DIR / f"{s.stem}.{tag}.o" for s in srcs]
    cmds = [[nvcc, *COMPILE_FLAGS, "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    logs, failed = [], []
    for cmd, proc in zip(cmds, procs):
        out, err = proc.communicate()
        logs.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}")
    try:
        if failed:
            raise KernelBuildError("\n".join(failed))
        logs.append(_run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                          *map(str, objs)]))
        os.replace(tmp, LIB_PATH)   # atomic: a concurrent loader sees old or new
    finally:
        tmp.unlink(missing_ok=True)
        for o in objs:
            o.unlink(missing_ok=True)
    return LIB_PATH, "".join(logs)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, with every function's
    argtypes and restype declared. Loaded once per process."""
    path, _ = build_library()
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    floats = ctypes.POINTER(ctypes.c_float)
    # (vox, coords, out, B, D, H, W, C, N, stream)
    lib.lgzt_trilinear_fwd.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
    lib.lgzt_trilinear_fwd.restype = i32
    # (g, coords, dvox, cnt, off, map, B, D, H, W, C, N, stream)
    lib.lgzt_trilinear_bwd.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
    lib.lgzt_trilinear_bwd.restype = i32
    # (x, w0k, wpack, bias, gammas, betas, out, B, M, Cin, H, L, n_film,
    #  rows_per_block, w0s, stream)
    lib.lgzt_siren_trunk_fwd.argtypes = [ptr] * 7 + [i32] * 7 + [floats, ptr]
    lib.lgzt_siren_trunk_fwd.restype = i32
    # (x, w0k, wpack, bias, gammas, betas, dy, dx, dw0, dwm, db, dg, dbt,
    #  hstash, adstash, part, part2, ps, B, M, Cin, H, L, n_film,
    #  rows_per_block, n_split, w0s, stream)
    lib.lgzt_siren_trunk_bwd.argtypes = [ptr] * 18 + [i32] * 8 + [floats, ptr]
    lib.lgzt_siren_trunk_bwd.restype = i32
    f32 = ctypes.c_float
    # (x, dirs, wpack, bias, gam, bet, wrgb, brgb, walpha, balpha, rgb,
    #  alpha, B, M, N, H, rows_per_block, w0, stream)
    lib.lgzt_siren_head_fwd.argtypes = [ptr] * 12 + [i32] * 5 + [f32, ptr]
    lib.lgzt_siren_head_fwd.restype = i32
    # (x, dirs, wpack, bias, gam, bet, wrgb, walpha, rgb, alpha, grgb,
    #  galpha, dx, ddir, dastash, part, part2, dw, db, dg, dbt, dwr, dbr,
    #  dwa, dba, B, M, N, H, rows_per_block, n_split, w0, stream)
    lib.lgzt_siren_head_bwd.argtypes = [ptr] * 25 + [i32] * 6 + [f32, ptr]
    lib.lgzt_siren_head_bwd.restype = i32
    return lib
