"""Build the package's CUDA sources into a shared library and load it.

The kernels in `csrc/` have a plain C interface. At first use, `load()`
compiles them with `nvcc` for Hopper (`sm_90a`) into
`optix_renderer_tpu_torch/_build/libpathk_<hash>.so`, where the hash covers
the sources and the flags, so an edited source is rebuilt and an unchanged
one is reused. The library is loaded with `ctypes`; no PyTorch headers are
compiled. There is no fallback: a missing `nvcc` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("mega.cuh", "pathk.cu")
# no --use_fast_math: the samplers go through logf/sinf/cosf and must keep
# full-precision results to track the plain version per pixel.
# -fmad=false: no FMA contraction, so every product and sum rounds as in the
# plain torch version and the kernel's rows equal it bit for bit. With
# contraction the kernel is ~10 % faster on an H100, but a camera ray that
# grazes a silhouette can take its first hit on another surface.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None  # the loaded library, once per process
last_build = {}  # {"path", "seconds", "ptxas"} of the build or load in this process


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels of this package build with "
                           "the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return found


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libpathk_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for this hash exists; returns its path."""
    out = library_path()
    t0 = time.time()
    ptxas = ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "pathk.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        ptxas = proc.stderr
        os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    last_build.update(path=str(out), seconds=time.time() - t0, ptxas=ptxas)
    return out


def load() -> ctypes.CDLL:
    """Build if needed and load the library, with its C signatures declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.pathk_trace_launch.argtypes = [
            vp, vp, vp, vp,  # out, scal_f, em_rows, env
            vp, i,  # sph, sphere rows
            vp, i, vp, i,  # tri, t_cnt, et, te_cnt
            i, i, i, i, i, i,  # n_pix, width, spp0, seed, n_spp, max_depth
            i, i,  # n_emitters, n_lights
            i, i, i,  # mis, rfilter, use_dof
            vp,  # stream
        ]
        lib.pathk_trace_launch.restype = i
        lib.pathk_error_string.argtypes = [i]
        lib.pathk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def error_string(code: int) -> str:
    return load().pathk_error_string(code).decode()
