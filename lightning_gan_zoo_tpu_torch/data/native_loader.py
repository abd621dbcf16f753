"""ctypes binding of the native image decoder ``native/fastimage.cpp`` (the
port's own copy of lightning_gan_zoo_tpu/data/native_loader.py).

The library is a host decoder, not a device kernel: libjpeg and libpng
decode, a bilinear resize and the (x/255 − mean)/std normalisation run on
the CPU's threads, and the Trainer moves the batch to the card as before.
It is built with ``make -C native`` at first use (and again when the source
is newer than ``native/libfastimage.so``). Where it cannot be built or
loaded, one message is printed and the readers decode with PIL: that is the
JAX package's own behaviour, kept so that both packages read the same
pixels from the same files on any machine.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
LIB_PATH = NATIVE_DIR / "libfastimage.so"

_lock = threading.Lock()
_state: dict = {}   # "lib": the loaded CDLL or None once a build failed


def _build_and_load() -> Optional[ctypes.CDLL]:
    try:
        if not LIB_PATH.exists() or (LIB_PATH.stat().st_mtime < (
                NATIVE_DIR / "fastimage.cpp").stat().st_mtime):
            subprocess.run(["make", "-C", str(NATIVE_DIR)], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(str(LIB_PATH))
    except subprocess.CalledProcessError as e:
        print(f"[fastimage] native loader unavailable (make failed: "
              f"{e.stderr.decode(errors='replace').strip()[-300:]}); "
              "falling back to PIL")
        return None
    except OSError as e:
        print(f"[fastimage] native loader unavailable ({e}); falling back "
              "to PIL")
        return None
    lib.fastimage_load_batch.restype = ctypes.c_int
    lib.fastimage_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)]
    return lib


def library() -> Optional[ctypes.CDLL]:
    """The decoder library, built and loaded once per process; None when it
    cannot be (the message is printed once)."""
    with _lock:
        if "lib" not in _state:
            _state["lib"] = _build_and_load()
        return _state["lib"]


def available() -> bool:
    return library() is not None


def load_batch(paths: Sequence[str], img_size: int, n_channels: int,
               mean: float, std: float) -> Optional[np.ndarray]:
    """Decode, resize and normalise on up to 16 host threads → (N, S, S, C)
    float32 NHWC; None when the library is unavailable. Raises IOError
    naming a file the decoder refuses (a format other than JPEG or PNG)."""
    lib = library()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, img_size, img_size, n_channels), np.float32)
    failed = np.full((n,), -1, np.int32)
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.fastimage_load_batch(
        names, n, img_size, n_channels, ctypes.c_float(mean),
        ctypes.c_float(std),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        min(os.cpu_count() or 1, 16),
        failed.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    bad = failed[failed >= 0]
    if len(bad):
        raise IOError(f"fastimage failed to decode {len(bad)} images, e.g. "
                      f"{paths[int(bad[0])]}")
    return out
