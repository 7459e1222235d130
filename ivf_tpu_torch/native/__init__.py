"""Native (C++) host helpers, loaded via ctypes (copy of
``ivf_tpu/native/__init__.py``).

``decode_batch`` is the clip loader's JPEG decode path: all frames of a
batch decoded in parallel by libjpeg worker threads into one numpy buffer
(GIL released for the whole call). It runs on the host, not the card.
Where the shared library cannot be built (no compiler, no libjpeg
headers) ``available()`` is False and the loaders decode with PIL; both
give the same uint8 (``tests/test_torch_data.py``).

The library is built at first use by one ``g++ -O3 -shared -fPIC
-std=c++17 decode.cpp -ljpeg -lpthread`` into
``ivf_tpu_torch/_build/libivf_native.so`` (written under a temporary name
and renamed, so processes that build at once never load a partial
file), and rebuilt when ``decode.cpp`` is newer.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "decode.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libivf_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-ljpeg", "-lpthread", "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (subprocess.CalledProcessError, FileNotFoundError, subprocess.TimeoutExpired):
        return False
    os.replace(tmp, _LIB_PATH)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) or os.path.getmtime(_SRC) > os.path.getmtime(_LIB_PATH):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        lib.ivf_decode_batch.restype = ctypes.c_int
        lib.ivf_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.ivf_jpeg_dims.restype = ctypes.c_int
        lib.ivf_jpeg_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def jpeg_dims(data: bytes) -> Tuple[int, int]:
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.ivf_jpeg_dims(data, len(data), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise ValueError("not a decodable JPEG")
    return h.value, w.value


def decode_batch(
    payloads: Sequence[bytes],
    height: Optional[int] = None,
    width: Optional[int] = None,
    n_threads: int = 8,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Decode a list of JPEG byte strings to one (n, h, w, 3) uint8 array."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    n = len(payloads)
    if n == 0:
        if height is None or width is None:
            raise ValueError("empty batch needs explicit height/width")
        return np.empty((0, height, width, 3), np.uint8)
    if height is None or width is None:
        height, width = jpeg_dims(payloads[0])
    if out is None:
        out = np.empty((n, height, width, 3), np.uint8)
    elif not (out.shape == (n, height, width, 3) and out.dtype == np.uint8 and out.flags["C_CONTIGUOUS"]):
        # the C side writes raw bytes at out.ctypes.data: a wrong shape,
        # dtype or layout would corrupt memory silently
        raise ValueError(f"out must be C-contiguous uint8 {(n, height, width, 3)}: {out.shape} {out.dtype}")
    ptrs = (ctypes.c_char_p * n)(*payloads)
    lens = (ctypes.c_size_t * n)(*[len(p) for p in payloads])
    rc = lib.ivf_decode_batch(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_char_p)),
        lens,
        n,
        out.ctypes.data_as(ctypes.c_void_p),
        height,
        width,
        n_threads,
    )
    if rc != 0:
        raise ValueError(f"JPEG {rc - 1} failed to decode or has mismatched dimensions")
    return out
