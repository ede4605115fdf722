"""Build and load the port's native libraries.

Each source under ``csrc/`` is compiled into a shared library with a plain
C interface, under ``build/`` at the root of the checkout, and loaded with
``ctypes``. ``SOURCES`` holds, for each library, its source, compiler,
flags and linked libraries: the CUDA kernels (``*.cu``) by ``nvcc`` for
``sm_90a``; the nvJPEG binding (``nvjpeg_codec.cpp``, host code) by
``nvcc``, linked with ``-lnvjpeg``; the PNG row unfilter
(``png_unfilter.cpp``, host code without CUDA) by the host's C++
compiler, so it builds wherever one is. A library is named after the hash
of its source, the headers under ``csrc/`` (``*.cuh``, which the sources
include) and that entry, so an edit to any of them rebuilds it and an
unchanged library is reused. ``BUILT``, ``CACHE_HITS`` and ``BUILD_SECONDS``
record each build, each reuse of a library already on disk and each
batch's time (``utils/compile_stats.py`` summarises them).
Nothing here runs at import time: the CPU-only tests import every module
of the package without a compiler or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, NamedTuple

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parent / "build"
_CSRC = _PKG / "csrc"

# -fmad=false: s, alpha and the transmittance round exactly as the plain
# PyTorch version's separate elementwise ops do, so the 1/255 and 1e-4
# threshold decisions agree with it (scripts/port_kernel_ab.py --no-fmad
# times the kernels without it). No --use_fast_math: __expf would move those
# decisions too.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
]
# host code through nvcc (it finds the toolkit's headers and libraries):
# no device code, so no -fmad or ptxas flags
NVCC_HOST_FLAGS = NVCC_FLAGS[:2] + ["-std=c++17", "-O2", "-shared",
                                    "-Xcompiler", "-fPIC"]
# host code without CUDA, for the host's C++ compiler
HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]


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


def cxx_path() -> str:
    for cand in (os.environ.get("CXX", ""), "c++", "g++"):
        path = shutil.which(cand) if cand else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found for the host libraries")


class Source(NamedTuple):
    """How one library is built: its source, the function that finds its
    compiler, the flags and the toolkit libraries it links."""
    path: Path
    compiler: Callable[[], str] = nvcc_path
    flags: tuple = tuple(NVCC_FLAGS)
    link: tuple = ()


SOURCES = {
    "blend_lists": Source(_CSRC / "blend_lists.cu"),
    "blend_macros": Source(_CSRC / "blend_macros.cu"),
    "remap": Source(_CSRC / "remap.cu"),
    "sgbm": Source(_CSRC / "sgbm.cu"),
    "ycc_rgb": Source(_CSRC / "ycc_rgb.cu"),
    "nvjpeg_codec": Source(_CSRC / "nvjpeg_codec.cpp",
                           flags=tuple(NVCC_HOST_FLAGS), link=("-lnvjpeg",)),
    "png_unfilter": Source(_CSRC / "png_unfilter.cpp", compiler=cxx_path,
                           flags=tuple(HOST_FLAGS)),
}

# the build record, in order: (source name, compiler exit code) of each
# library built, the name of each reused from disk, and the wall seconds
# of each batch of builds (they run in parallel)
BUILT: list[tuple[str, int]] = []
CACHE_HITS: list[str] = []
BUILD_SECONDS: list[float] = []
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_LOG: dict[str, str] = {}


def _command(name: str, out: Path) -> list[str]:
    src = SOURCES[name]
    compiler = src.compiler()
    link = list(src.link)
    if link:   # find the toolkit's libraries at load time too
        lib = Path(compiler).resolve().parent.parent / "lib64"
        link += ["-Xlinker", f"-rpath={lib}"]
    return [compiler, *src.flags, "-o", str(out), str(src.path), *link]


def _lib_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.path.read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join([src.compiler.__name__, *src.flags,
                       *src.link]).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Build every missing library of ``names`` (default: all) at once, one
    compiler process per source started together; returns each source's
    library path."""
    names = list(SOURCES) if names is None else list(names)
    with _LOCK:
        jobs = {}
        t0 = time.perf_counter()
        for name in names:
            out = _lib_path(name)
            if out.exists():
                CACHE_HITS.append(name)
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = _command(name, tmp)
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, out)
        for name, (proc, _, _) in jobs.items():
            BUILD_LOG[name] = proc.communicate()[0]
            BUILT.append((name, proc.returncode))
        if jobs:
            BUILD_SECONDS.append(time.perf_counter() - t0)
        for name, (proc, tmp, out) in jobs.items():
            if proc.returncode != 0:
                raise RuntimeError(f"build failed for {name}:\n"
                                   f"{BUILD_LOG[name]}")
            os.replace(tmp, out)
    return {n: _lib_path(n) for n in names}


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_CP, _SZ = ctypes.c_char_p, ctypes.c_size_t
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
    "remap": {"remap_u8": [_VP] * 4 + [_I] * 5 + [_VP],
              "remap_pair_u8": [_VP] * 8 + [_I] * 5 + [_VP]},
    "ycc_rgb": {"ycc_rgb_u8": [_VP] * 4 + [_I] * 6 + [_VP]},
    "sgbm": {"sgbm_run": [_VP] * 7 + [_I] * 2 + [_VP] * 2,
             "sgbm_grids": [_I, _I, _VP]},
    "nvjpeg_codec": {
        "jpeg_info": [_CP, _SZ] + [ctypes.POINTER(_I)] * 3,
        "jpeg_decode": [_CP, _SZ] + [_VP] * 3 + [ctypes.POINTER(_I), _VP],
        "jpeg_encode": [_VP] + [_I] * 3 + [_CP, _SZ, ctypes.POINTER(_SZ),
                                            _VP],
    },
    "png_unfilter": {"png_unfilter": [_CP, _VP] + [_I] * 3},
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
    path = build_all([name])[name]
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = load(path, name)
    return lib


def stream_handle(index: int) -> int:
    """PyTorch's current CUDA stream on the device of ``index`` for this
    thread, as the handle the libraries' entries take: one call, with no
    device lookup or stream object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)
