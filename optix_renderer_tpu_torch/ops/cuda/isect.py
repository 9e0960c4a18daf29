"""Closest-hit / any-hit of a ray wavefront: kernel wrappers and plain versions.

Counterpart of the JAX package's intersection kernels
(`ops/pallas/cluster.py: cluster_raw`, `ops/pallas/mxu_intersect.py:
mxu_raw`, `ops/pallas/mt_kernel.py: _mt_pallas`), which all compute the
closest (or any) hit of N rays against the triangle table. Two CUDA kernels
in `csrc/isect.cu` take their place, one thread per ray:

* `isect_bvh` — stackless walk of the packed LBVH (`ops/bvh.py`), closest
  hit or any hit; plain version `ops/bvh.py: traverse_walk_ref`;
* `isect_brute` — sweep of every triangle in shared-memory tiles of 256;
  plain version `mt_sweep_ref` below.

Both take o, d [N,3] and mint, cutoff [N] float32 and return (id [N] int32,
−1 on a miss; t, u, v [N] float32; t = cutoff on a miss). A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises. Each wrapper
adds one to `LAUNCHES[name]` where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes

import torch

from optix_renderer_tpu_torch.ops.bvh import BIG, mt_lanes, traverse_walk_ref
from optix_renderer_tpu_torch.ops.cuda import _build

# kernel launches by the wrappers (not by the plain versions)
LAUNCHES = {"isect_bvh_closest": 0, "isect_bvh_any": 0, "isect_brute": 0}

# ray-triangle pairs per step of the plain sweep (bounds its [N, chunk] temporaries)
_SWEEP_PAIRS = 1 << 22


def mt_sweep_ref(o, d, mint, cutoff, v0, e1, e2):
    """Plain brute-force closest hit: chunked [N, T] Möller–Trumbore + argmin.

    Within a chunk `argmin` takes the lowest index among equal t; across
    chunks a later chunk wins only with a strictly smaller t, so the overall
    winner is the lowest-index minimum, as in `_mt_jnp` and the kernel.
    """
    n, t_cnt = o.shape[0], v0.shape[0]
    best_id = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    best_t = cutoff.clone()
    best_u = torch.zeros(n, dtype=torch.float32, device=o.device)
    best_v = torch.zeros_like(best_u)
    chunk = max(1, min(t_cnt, _SWEEP_PAIRS // max(n, 1)))
    rows = torch.arange(n, device=o.device)
    for c0 in range(0, t_cnt, chunk):
        sl = slice(c0, c0 + chunk)
        t, u, v, h = mt_lanes(o[:, None, :], d[:, None, :], v0[None, sl], e1[None, sl],
                              e2[None, sl])
        h = h & (t >= mint[:, None]) & (t < cutoff[:, None])
        tm = torch.where(h, t, BIG)
        j = torch.argmin(tm, dim=1)
        tj = tm[rows, j]
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_u = torch.where(better, u[rows, j], best_u)
        best_v = torch.where(better, v[rows, j], best_v)
        best_id = torch.where(better, (j + c0).to(torch.int32), best_id)
    return best_id, best_t, best_u, best_v


def _check_rays(o, d, mint, cutoff):
    n = o.shape[0]
    for name, x, shape in (("o", o, (n, 3)), ("d", d, (n, 3)), ("mint", mint, (n,)),
                           ("cutoff", cutoff, (n,))):
        if tuple(x.shape) != shape or x.dtype != torch.float32 or x.device != o.device:
            raise ValueError(f"{name} must be float32 {shape} on {o.device}, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if n >= 2**31:
        raise ValueError(f"{n} rays exceed the kernels' 32-bit index")


def _outputs(n, device):
    return (torch.empty(n, dtype=torch.int32, device=device),
            *(torch.empty(n, dtype=torch.float32, device=device) for _ in range(3)))


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


def _launch(entry: str, name: str, *args, device):
    """Call the library's C entry point on the current stream; count the
    launch under `name`, or raise with the CUDA error."""
    fn = getattr(_build.load(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} "
                           f"({_build.error_string(rc)})")
    LAUNCHES[name] += 1


def isect_bvh(packed, leaf, o, d, mint, cutoff, any_hit: bool = False,
              with_visits: bool = False):
    """Closest (or any) hit of the rays against the packed LBVH.

    packed [Nn,8] and leaf [n_leaves,40] float32 (`ops/bvh.py`). Returns
    (id, t, u, v), plus, when `with_visits`, [2, N] int32 with the nodes
    visited and the leaves tested per ray (the diagnostic rows 4/5 of
    `cluster_raw(debug=True)`). With `any_hit` a ray stops at its first
    confirmed hit, so its (id, t) is *a* hit in [mint, cutoff), not the
    nearest.
    """
    if o.device.type == "cpu":
        return traverse_walk_ref(packed, leaf, o, d, mint, cutoff, any_hit, with_visits)
    if o.device.type != "cuda":
        raise ValueError(f"isect_bvh runs on cpu or cuda tensors, got {o.device}")
    _check_rays(o, d, mint, cutoff)
    for name, x, cols in (("packed", packed, 8), ("leaf", leaf, 40)):
        if (x.dim() != 2 or x.shape[1] != cols or x.dtype != torch.float32
                or x.device != o.device or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned float32 "
                             f"[rows, {cols}] tensor on {o.device}")
    if not 0 < packed.shape[0] < 2**31:
        raise ValueError("the LBVH must have between 1 and 2^31 - 1 nodes")
    o, d, mint, cutoff = (x.contiguous() for x in (o, d, mint, cutoff))
    n = o.shape[0]
    out = _outputs(n, o.device)
    visits = torch.empty((2, n), dtype=torch.int32, device=o.device) if with_visits else None
    if n == 0:
        return (*out, visits) if with_visits else out
    _launch("isect_bvh_launch", "isect_bvh_any" if any_hit else "isect_bvh_closest",
            _ptr(packed), packed.shape[0], _ptr(leaf), _ptr(o), _ptr(d), _ptr(mint),
            _ptr(cutoff), n, int(any_hit), *(_ptr(x) for x in out), _ptr(visits),
            device=o.device)
    return (*out, visits) if with_visits else out


def isect_brute(tri, o, d, mint, cutoff):
    """Closest hit of the rays against every triangle of `tri` [T,9] float32,
    v0 | e1 | e2 per row (`scene.data.Geometry.tri_table`)."""
    if o.device.type == "cpu":
        return mt_sweep_ref(o, d, mint, cutoff, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
    if o.device.type != "cuda":
        raise ValueError(f"isect_brute runs on cpu or cuda tensors, got {o.device}")
    _check_rays(o, d, mint, cutoff)
    t_cnt = tri.shape[0]
    if not 0 < t_cnt < 2**31 // 9:
        raise ValueError(f"isect_brute takes 1 to {2**31 // 9 - 1} triangles, got {t_cnt}")
    if (tri.shape != (t_cnt, 9) or tri.dtype != torch.float32 or tri.device != o.device
            or not tri.is_contiguous()):
        raise ValueError(f"tri must be a contiguous float32 [T, 9] tensor on {o.device}")
    o, d, mint, cutoff = (x.contiguous() for x in (o, d, mint, cutoff))
    n = o.shape[0]
    out = _outputs(n, o.device)
    if n == 0:
        return out
    _launch("isect_brute_launch", "isect_brute", _ptr(tri), t_cnt, _ptr(o),
            _ptr(d), _ptr(mint), _ptr(cutoff), n, *(_ptr(x) for x in out), device=o.device)
    return out
