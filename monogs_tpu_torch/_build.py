"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, under ``build/`` at the root of the
checkout, and loaded with ``ctypes``. A library is named after the hash of
its source, the headers under ``csrc/`` (``*.cuh``, which the sources
include) and the flags, so an edit to any of them rebuilds it and an
unchanged library is reused. Nothing here runs at import time: the
CPU-only tests import every module of the package without a compiler or a
card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build"
_CSRC = _PKG / "csrc"
SOURCES = {"blend_lists": _CSRC / "blend_lists.cu",
           "blend_macros": _CSRC / "blend_macros.cu"}

# -fmad=false: s, alpha and the transmittance round exactly as the plain
# PyTorch version's separate elementwise ops do, so the 1/255 and 1e-4
# threshold decisions agree with it (scripts/port_kernel_ab.py --no-fmad
# times the kernels without it). No --use_fast_math: __expf would move those
# decisions too.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: dict[str, str] = {}


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME", "") + "/bin/nvcc",
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all() -> dict[str, Path]:
    """Build every missing library at once, one nvcc process per source
    started together; returns each source's library path."""
    with _LOCK:
        jobs = {}
        for name, src in SOURCES.items():
            out = _lib_path(name)
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, out)
        for name, (proc, _, _) in jobs.items():
            BUILD_LOG[name] = proc.communicate()[0]
        for name, (proc, tmp, out) in jobs.items():
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n"
                                   f"{BUILD_LOG[name]}")
            os.replace(tmp, out)
    return {n: _lib_path(n) for n in SOURCES}


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "blend_lists": {
        "blend_fwd": [_VP] * 6 + [_I] * 5 + [_VP],
        "blend_fo_grad": [_VP] * 11 + [_I] * 6 + [_F] * 4 + [_VP],
        "blend_jvp8": [_VP] * 7 + [_I] * 5 + [_VP],
        "blend_map_grad": [_VP] * 11 + [_I] * 6 + [_F] * 3 + [_VP],
        "blend_bwd": [_VP] * 6 + [_I] * 5 + [_VP],
        "blend_fused_attrs": [_I, _I, _VP],
        "blend_fwd_attrs": [_I, _I, _VP],
    },
    "blend_macros": {
        "macro_fwd": [_VP] * 6 + [_I] * 8 + [_VP],
        "macro_bwd": [_VP] * 7 + [_I] * 8 + [_VP],
        "macro_scratch_bytes": [_I] * 6,
        "macro_attrs": [_I, _VP],
    },
}
_RESTYPES = {"macro_scratch_bytes": ctypes.c_size_t}


def load(path: Path, name: str) -> ctypes.CDLL:
    """Load a built library with the C interface of source ``name``."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = build_all()[name]
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = load(path, name)
    return lib
