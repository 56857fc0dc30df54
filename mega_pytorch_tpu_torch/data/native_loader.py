"""ctypes bindings of the native JPEG loader (counterpart of
``mega_pytorch_tpu/data/native_loader.py``; the core is ``csrc/loader.cpp``,
a copy of the JAX package's).

The library is built with g++ at first use (``-O3 -march=native``, linked
against libjpeg and pthreads) into ``csrc/build/``, under a name keyed by
the source's hash and the host's identity, so a binary built from other
sources or for another CPU is never loaded. ``load_frame`` decodes one JPEG,
resizes it with a triangle filter (PIL's family, not bit for bit: the
PIL-exact resize is ``data/transforms.resize_bilinear_u8``), normalises to
BGR255 minus the pixel mean and places it on a zero canvas; ``load_batch``
does the same over a thread pool. Host code: no path of the card depends on
it, and ``available()`` is False where g++ or ``jpeglib.h`` is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / "csrc"
_LIB = None
_LOCK = threading.Lock()
_FLOAT_P = ctypes.POINTER(ctypes.c_float)
_INT_P = ctypes.POINTER(ctypes.c_int)


def _build_lib() -> Path:
    """The library's path, compiled first if no build of these sources for
    this host exists (raises ``subprocess.CalledProcessError`` with g++'s
    output, or ``FileNotFoundError`` without g++)."""
    src = CSRC / "loader.cpp"
    build_dir = CSRC / "build"
    build_dir.mkdir(parents=True, exist_ok=True)
    key = hashlib.sha256(
        src.read_bytes() + f"|{platform.machine()}|{platform.processor()}".encode()
    ).hexdigest()[:16]
    lib_path = build_dir / f"libmegaloader-{key}.so"
    if lib_path.exists():
        return lib_path
    tmp_path = lib_path.with_name(lib_path.name + f".tmp{threading.get_native_id()}")
    subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
                    str(src), "-o", str(tmp_path), "-ljpeg", "-lpthread"],
                   check=True, capture_output=True, text=True)
    tmp_path.replace(lib_path)
    return lib_path


def get_lib():
    """The native library (built if needed), or raise."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build_lib()))
            lib.decode_resize_normalize.restype = ctypes.c_int
            lib.decode_resize_normalize.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, _FLOAT_P, _INT_P,
            ]
            lib.decode_batch.restype = ctypes.c_int
            lib.decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, _INT_P, ctypes.c_int, ctypes.c_int, _FLOAT_P, _INT_P,
                ctypes.c_int,
            ]
            _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except (OSError, subprocess.CalledProcessError):
        return False
    return True


def _check_canvas(canvas_h: int, canvas_w: int) -> None:
    if canvas_h <= 0 or canvas_w <= 0:
        raise ValueError(f"canvas must be positive, got {canvas_h}x{canvas_w}")


def load_frame(path: str, min_size: int, max_size: int, flip: bool,
               canvas_h: int, canvas_w: int):
    """→ (canvas (H, W, 3) f32 normalised BGR255, (oh, ow) the resized size)."""
    _check_canvas(canvas_h, canvas_w)
    lib = get_lib()
    out = np.zeros((canvas_h, canvas_w, 3), np.float32)
    hw = np.zeros(2, np.int32)
    rc = lib.decode_resize_normalize(str(path).encode(), min_size, max_size, int(flip),
                                     canvas_h, canvas_w, out.ctypes.data_as(_FLOAT_P),
                                     hw.ctypes.data_as(_INT_P))
    if rc != 0:
        raise IOError(f"native decode failed ({rc}) for {path}")
    return out, (int(hw[0]), int(hw[1]))


def load_batch(paths: list[str], min_size: int, max_size: int, flips: list[bool],
               canvas_h: int, canvas_w: int, num_threads: int = 8):
    """Decode a batch over ``num_threads`` threads → ((N, H, W, 3) f32,
    (N, 2) f32 resized sizes)."""
    _check_canvas(canvas_h, canvas_w)
    if len(flips) != len(paths):
        raise ValueError(f"{len(paths)} paths but {len(flips)} flips")
    lib = get_lib()
    n = len(paths)
    outs = np.zeros((n, canvas_h, canvas_w, 3), np.float32)
    hws = np.zeros((n, 2), np.int32)
    names = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    flips_arr = np.asarray(flips, np.int32)
    failures = lib.decode_batch(names, n, min_size, max_size,
                                flips_arr.ctypes.data_as(_INT_P), canvas_h, canvas_w,
                                outs.ctypes.data_as(_FLOAT_P), hws.ctypes.data_as(_INT_P),
                                num_threads)
    if failures:
        raise IOError(f"native batch decode: {failures}/{n} failures")
    return outs, hws.astype(np.float32)
