"""Builds and loads the port's CUDA kernels (``csrc/*.cu``).

All sources are compiled by ``nvcc`` for ``sm_90a``, one ``nvcc`` per
source, all started together, and linked into ONE shared library with a
plain C interface, loaded with ``ctypes``; no PyTorch headers are involved,
so a build takes seconds. The library's file name carries a hash of
the flags and of every source and header (``*.cu``, ``*.cuh``), so an edited
file is rebuilt on first use and an unchanged tree is loaded as it is.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C entry point -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "stem_pool_packed_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "stem_pool_packed_folded_launch": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I),
    "relation_attention_launch": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ),
    "position_bias_launch": (_P, _P, _P, _P, _I, _I, _P),
    "roi_align_launch": (
        _P, _P, _P, _I, _I, _I, _I, _I, _L, _L, _L, _I, _I, _F, _I, _I, _I, _I, _P,
    ),
    "bottleneck_epilogue_launch": (_P, _P, _P, _P, _L, _I, _I, _P),
}


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    built: bool  # False when an up-to-date library was only loaded
    seconds: float
    ptxas: list[str]  # nvcc -Xptxas -v register / shared-memory lines


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _digest(files: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


_LOADED: list[KernelLibrary] = []  # the process's library, once loaded


def build_library(csrc: Path, build_dir: Path) -> KernelLibrary:
    """Build (if needed) and load the library of the sources in ``csrc``
    (every ``*.cu``, hashed with every ``*.cuh``) into ``build_dir``
    (tools/kernel_ab.py also builds another commit's ``csrc`` with it)."""
    sources = sorted(csrc.glob("*.cu"))
    digest = _digest(sorted([*sources, *csrc.glob("*.cuh")]))
    build_dir.mkdir(parents=True, exist_ok=True)
    target = build_dir / f"libmega_kernels_{digest}.so"
    t0 = time.perf_counter()
    built, ptxas = False, []
    if not target.exists():
        objs = [build_dir / f"{src.stem}_{digest}.{os.getpid()}.o" for src in sources]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [proc.communicate()[0] for proc in procs]
        for proc, log in zip(procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
        os.replace(tmp, target)
        for obj in objs:
            obj.unlink()
        built = True
        ptxas = [
            line.strip() for line in "".join(logs).splitlines()
            if any(key in line for key in ("Compiling entry", "registers",
                                           "smem", "bytes stack frame"))
        ]
    lib = ctypes.CDLL(str(target))
    for name, argtypes in SIGNATURES.items():
        if not hasattr(lib, name):  # another commit's library may predate an entry
            continue
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, target, built, time.perf_counter() - t0, ptxas)


def load_library() -> KernelLibrary:
    """Build (if needed) and load the package's kernel library, once per
    process."""
    if not _LOADED:
        _LOADED.append(build_library(CSRC, BUILD_DIR))
    return _LOADED[0]


def check_launch(status: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if status != 0:
        raise RuntimeError(f"{name}: launch failed with cudaError_t {status}")
