"""Build the package's CUDA sources into a shared library and load it.

The kernels in `csrc/` have a plain C interface. At first use, `load()`
compiles each `.cu` file with its own `nvcc`, all started together, and
links the objects for Hopper (`sm_90a`) into one library,
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
from pathlib import Path

from optix_renderer_tpu_torch.utils import tracing

PKG = Path(__file__).resolve().parents[2]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = ("mega.cuh", "walk.cuh", "pathk.cu", "isect.cu", "probes.cu", "track.cu", "lbvh.cu",
           "scan.cu", "film.cu")
UNITS = tuple(name for name in SOURCES if name.endswith(".cu"))
# no --use_fast_math: the samplers go through logf/sinf/cosf and must keep
# full-precision results to track the plain version per pixel.
# -fmad=false: no FMA contraction, so every product and sum rounds as in the
# plain torch version and the kernel's rows equal it bit for bit. With
# contraction the kernel is ~10 % faster on an H100, but a camera ray that
# grazes a silhouette can take its first hit on another surface.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None  # the loaded library, once per process
last_build = {}  # {"path", "ptxas"} of the build or load in this process; the time is
# the span `kernels.load` (utils/tracing.py)


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


def build() -> tuple[Path, bool]:
    """Compile the sources unless a library for this hash exists; returns its
    path and whether it was compiled."""
    out = library_path()
    ptxas = ""
    compiled = not out.exists()
    if compiled:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{out.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{Path(u).stem}.{tag}.o" for u in UNITS]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / u)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for u, obj in zip(UNITS, objs)]
        failed = []
        for u, p in zip(UNITS, procs):
            so, se = p.communicate()
            ptxas += f"[{u}]\n{se}"
            if p.returncode != 0:
                failed.append(f"{u} ({p.returncode}):\n{so}\n{se}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                               "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders never load a partial file
    last_build.update(path=str(out), ptxas=ptxas)
    return out, compiled


def load() -> ctypes.CDLL:
    """Build if needed and load the library, with its C signatures declared."""
    global _lib
    if _lib is not None:
        return _lib
    with tracing.setup_span("kernels.load") as span:
        path, compiled = build()
        span.set(built="compiled" if compiled else "loaded")
        lib = ctypes.CDLL(str(path))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.pathk_trace_launch.argtypes = [
            vp, vp, vp, vp,  # out, scal_f, em_rows, env
            vp, i,  # sph, sphere rows
            vp, i,  # tri, t_cnt
            vp, i, vp,  # nodes, n_nodes, leaf
            vp, i, i,  # et, te_cnt, te_pad
            i, i, i, i, i, i, i,  # pix0, n_pix, width, spp0, seed, n_spp, max_depth
            i, i,  # n_emitters, n_lights
            i, i, i,  # mis, rfilter, use_dof
            vp,  # next_pix: the kernel's uint32 pixel counter, 0 at launch
            vp,  # stream
        ]
        lib.pathk_trace_launch.restype = i
        lib.pathk_last_launch.argtypes = [vp] * 5  # int* medium, blocks, threads, per SM, smem
        lib.pathk_last_launch.restype = None
        lib.isect_bvh_launch.argtypes = [
            vp, vp,  # pairs, leaf
            vp, vp, vp, vp, i, i,  # o, d, mint, cutoff, n, any_hit
            vp, vp, vp, vp, vp,  # out id, t, u, v, visits (or null)
            vp,  # next_ray: the kernel's uint32 ray counter, 0 at launch
            vp,  # stream
        ]
        lib.isect_bvh_launch.restype = i
        lib.isect_spheres_launch.argtypes = [
            vp, vp,  # pairs, leaf [n_leaves, 20]
            vp, vp, vp, vp, i, i,  # o, d, mint, cutoff, n, any_hit
            vp, vp, vp,  # out id, t, visits (or null)
            vp,  # next_ray: the kernel's uint32 ray counter, 0 at launch
            vp,  # stream
        ]
        lib.isect_spheres_launch.restype = i
        lib.isect_bvh_last_launch.argtypes = [vp] * 3  # int* blocks, threads, per SM
        lib.isect_bvh_last_launch.restype = None
        lib.isect_brute_launch.argtypes = [
            vp, i,  # tri [t_cnt, 9], t_cnt
            vp, vp, vp, vp, i,  # o, d, mint, cutoff, n
            i,  # vec: the rays' arrays are 16-byte aligned (vector loads)
            vp, vp, vp, vp,  # out id, t, u, v
            vp,  # stream
        ]
        lib.isect_brute_launch.restype = i
        lib.isect_brute_last_launch.argtypes = [vp] * 3  # int* blocks, threads, per SM
        lib.isect_brute_last_launch.restype = None
        lib.isect_rcp_check_launch.argtypes = [vp, vp]  # uint64 counts [2], stream
        lib.isect_rcp_check_launch.restype = i
        lib.probe_copy_launch.argtypes = [
            vp, vp, vp,  # x, sel, out
            vp,  # info: int32 [128, 2] (SM, cluster CTAs per CTA) or null
            vp,  # stream
        ]
        lib.probe_copy_launch.restype = i
        lib.probe_empty_launch.argtypes = [vp]  # stream
        lib.probe_empty_launch.restype = i
        lib.iter_cost_launch.argtypes = [
            vp, vp, vp,  # x, tri, out
            i, i, i,  # nb, n_it, mode
            vp,  # info: int32 [nb * 4, 2] (SM, cluster CTAs per CTA) or null
            vp,  # stream
        ]
        lib.iter_cost_launch.restype = i
        lib.track_launch.argtypes = [
            i,  # ratio: 0 delta tracking, 1 ratio tracking
            vp, vp, vp, vp, i,  # ro, rd, t_max, med, n
            vp, vp, vp, vp,  # pcg32 state hi, lo, increment hi, lo (int64 words)
            vp, vp, vp, vp, vp,  # media: type, sigma_a, sigma_s, density scale, vol id
            vp, vp, vp, vp, vp,  # volumes: bbox min, max, dims, majorant, corner stack
            i, i, i,  # the padded grid D, H, W
            vp, vp, vp, vp,  # out t_event / T, K, new state hi, lo
            vp,  # iters_max: one uint32, set to L
            vp,  # stream
        ]
        lib.track_launch.restype = i
        ll = ctypes.c_longlong
        lib.lbvh_keys_launch.argtypes = [
            vp, vp, vp, ll,  # v0, v1, v2 [n, 3], n
            vp, vp, vp,  # scratch centroids [n, 3], scratch bounds (6 uint32), out keys [n]
            vp,  # stream
        ]
        lib.lbvh_keys_launch.restype = i
        lib.lbvh_tree_launch.argtypes = [
            vp, vp, vp, vp, ll,  # v0, v1, v2, radius (or null), n
            vp,  # the keys, sorted
            vp, vp, vp,  # out packed, leaf, pair-order keys
            i,  # the tree's levels
            vp,  # stream
        ]
        lib.lbvh_tree_launch.restype = i
        lib.lbvh_pairs_launch.argtypes = [
            vp, vp, vp, i,  # packed, the pair-order keys sorted, scratch row_of, n_leaves
            vp,  # out pairs
            vp,  # stream
        ]
        lib.lbvh_pairs_launch.restype = i
        lib.scan_shade_launch.argtypes = [
            vp, vp,  # the scene's tables, the lanes (csrc/scan.cu: sc::Scene, sc::Lanes)
            i, i, i,  # bounce, mis, fold_only
            vp,  # stream
        ]
        lib.scan_shade_launch.restype = i
        lib.film_splat_launch.argtypes = [
            vp, vp, vp, vp,  # img [k, h, w, 4], pos [n, 2], layers [k, n, 3], mask [n] (or null)
            i, i, i, i, i,  # k, h, w, n, filter (ops/cuda/film.py: FILTER_CODE)
            i,  # grad: 0 the splat, 1 its adjoint
            vp,  # stream
        ]
        lib.film_splat_launch.restype = i
        lib.pathk_error_string.argtypes = [i]
        lib.pathk_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def error_string(code: int) -> str:
    return load().pathk_error_string(code).decode()
