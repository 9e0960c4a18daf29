"""Closest-hit / any-hit of a ray wavefront: kernel wrappers and plain versions.

Counterpart of the JAX package's intersection kernels
(`ops/pallas/cluster.py: cluster_raw`, `ops/pallas/mxu_intersect.py:
mxu_raw`, `ops/pallas/mt_kernel.py: _mt_pallas`), which all compute the
closest (or any) hit of N rays against the triangle table. Two CUDA kernels
in `csrc/isect.cu` take their place:

* `isect_bvh` — walk of the LBVH's child-pair table (`ops/bvh.py:
  pack_child_pairs`), nearest child first from a short per-ray stack, in
  persistent warps whose lanes take their rays from a counter; closest hit
  or any hit; plain version `ops/bvh.py: traverse_pairs_ref`;
* `isect_brute` — sweep of every triangle: persistent blocks that stage a
  table of up to 256 triangles once in shared memory (larger ones tile by
  tile), each thread testing four consecutive rays against each staged
  triangle; plain version `mt_sweep_ref` below.

Both take o, d [N,3] and mint, cutoff [N] float32 and return (id [N] int32,
−1 on a miss; t, u, v [N] float32; t = cutoff on a miss).

* `isect_spheres` — the same pair walk over the spheres' LBVH (scenes of
  `MIN_SPHS_FOR_BVH` spheres or more; `csrc/isect.cu: bvh_kernel<ANY,
  SphLeaf>`), which no Pallas kernel had: the JAX package walks it with an
  XLA `lax.while_loop` (`optix_renderer_tpu/ops/bvh.py:517`). Returns (id,
  t); plain version `ops/bvh.py: traverse_spheres_ref`, the JAX skip-link
  walk, whose visit order differs, so an exact tie in t may go to another
  sphere.

All three refuse
tensors that require grad (`refuse_graph`): the caller detaches them and
replays the winner (`ops/intersect.py`). A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises. Each wrapper
adds one to the counter `launch.<name>` (`utils/tracing.py`) where it
launches its kernel, and nowhere else: `isect_bvh_closest`, `isect_bvh_any`,
`isect_brute`, `isect_spheres_closest`, `isect_spheres_any`.
"""

from __future__ import annotations

import ctypes

import torch

from optix_renderer_tpu_torch.ops.bvh import (
    BIG,
    PAIR_COLS,
    STACK_DEPTH,
    mt_lanes,
    traverse_pairs_ref,
    traverse_spheres_ref,
)
from optix_renderer_tpu_torch.ops.cuda import _build
from optix_renderer_tpu_torch.utils import tracing

# ray-triangle pairs per step of the plain sweep (bounds its [N, chunk] temporaries)
_SWEEP_PAIRS = 1 << 22


def _sweep_chunk(n: int, t_cnt: int) -> int:
    return max(1, min(t_cnt, _SWEEP_PAIRS // max(n, 1)))


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
    chunk = _sweep_chunk(n, t_cnt)
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


def mt_any_ref(o, d, mint, cutoff, v0, e1, e2):
    """Plain brute-force any hit: bool [N], true where some triangle is hit
    in [mint, cutoff); chunked as `mt_sweep_ref`."""
    n, t_cnt = o.shape[0], v0.shape[0]
    occl = torch.zeros(n, dtype=torch.bool, device=o.device)
    chunk = _sweep_chunk(n, t_cnt)
    for c0 in range(0, t_cnt, chunk):
        sl = slice(c0, c0 + chunk)
        t, _, _, h = mt_lanes(o[:, None, :], d[:, None, :], v0[None, sl], e1[None, sl],
                              e2[None, sl])
        occl |= (h & (t >= mint[:, None]) & (t < cutoff[:, None])).any(dim=1)
    return occl


def refuse_graph(name: str, *tensors) -> None:
    """Raise where a tensor that requires grad reaches a kernel wrapper: the
    kernels and the plain versions pick discrete winners (the plain ones by
    writing into their outputs in place), so their callers detach the
    inputs and replay the winner live (`ops/intersect.py`,
    `ops/volume_grid.py`)."""
    if any(t is not None and t.requires_grad for t in tensors):
        raise ValueError(f"{name} takes detached tensors: detach the inputs and replay the "
                         "result with autograd")


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
    tracing.count(f"launch.{name}")


def _check_depth(bvh):
    if bvh.depth > STACK_DEPTH:
        raise ValueError(f"the LBVH has {bvh.depth} levels, deeper than the pair walk's stack "
                         f"of {STACK_DEPTH} entries")


def _check_tree(bvh, leaf_cols: int, device):
    for name, x, cols in (("pairs", bvh.pairs, PAIR_COLS), ("leaf", bvh.leaf, leaf_cols)):
        if (x.dim() != 2 or x.shape[1] != cols or x.dtype != torch.float32
                or x.device != device or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned float32 "
                             f"[rows, {cols}] tensor on {device}")
    if not 0 < bvh.pairs.shape[0] < 2**31:
        raise ValueError("the LBVH must have between 1 and 2^31 - 1 pair rows")


def isect_spheres(sph_bvh, o, d, mint, cutoff, any_hit: bool = False,
                  with_visits: bool = False):
    """Closest (or any) hit of the rays against the spheres' LBVH.

    sph_bvh: the scene's `Geometry.sph_bvh` (`packed` [Nn, 8], `pairs`
    [n_pairs, 16], `leaf` [n_leaves, 20] float32). Returns (id [N] int32,
    −1 on a miss; t [N] float32, cutoff on a miss), plus, when
    `with_visits`, [2, N] int32: on the card the pair rows read and the
    leaves tested per ray, on the CPU the plain walk's nodes and leaves.
    A CPU tensor runs `traverse_spheres_ref`; a CUDA tensor launches
    `bvh_kernel<ANY, SphLeaf>` or raises.
    """
    refuse_graph("isect_spheres", sph_bvh.packed, sph_bvh.pairs, sph_bvh.leaf, o, d, mint,
                 cutoff)
    if o.device.type == "cpu":
        return traverse_spheres_ref(sph_bvh.packed, sph_bvh.leaf, o, d, mint, cutoff, any_hit,
                                    with_visits)
    if o.device.type != "cuda":
        raise ValueError(f"isect_spheres runs on cpu or cuda tensors, got {o.device}")
    _check_rays(o, d, mint, cutoff)
    _check_depth(sph_bvh)
    _check_tree(sph_bvh, 20, o.device)
    o, d, mint, cutoff = (x.contiguous() for x in (o, d, mint, cutoff))
    n = o.shape[0]
    out = _outputs(n, o.device)[:2]
    visits = torch.empty((2, n), dtype=torch.int32, device=o.device) if with_visits else None
    if n == 0:
        return (*out, visits) if with_visits else out
    next_ray = torch.zeros(1, dtype=torch.int32, device=o.device)
    _launch("isect_spheres_launch", "isect_spheres_any" if any_hit else "isect_spheres_closest",
            _ptr(sph_bvh.pairs), _ptr(sph_bvh.leaf), _ptr(o), _ptr(d), _ptr(mint), _ptr(cutoff),
            n, int(any_hit), *(_ptr(x) for x in out), _ptr(visits), _ptr(next_ray),
            device=o.device)
    return (*out, visits) if with_visits else out


def isect_bvh(bvh, o, d, mint, cutoff, any_hit: bool = False, with_visits: bool = False):
    """Closest (or any) hit of the rays against the LBVH.

    bvh: the scene's `scene.data.Bvh` (its `pairs` [n_pairs, 16] and `leaf`
    [n_leaves, 40] float32, and `depth`). Returns (id, t, u, v), plus, when
    `with_visits`, [2, N] int32 with the pair rows read and the leaves
    tested per ray. With `any_hit` a ray stops at its first confirmed hit,
    so its (id, t) is *a* hit in [mint, cutoff), not the nearest. Raises for
    a tree deeper than the walk's stack (`ops/bvh.py: STACK_DEPTH`).
    """
    _check_depth(bvh)
    pairs, leaf = bvh.pairs, bvh.leaf
    refuse_graph("isect_bvh", pairs, leaf, o, d, mint, cutoff)
    if o.device.type == "cpu":
        return traverse_pairs_ref(pairs, leaf, o, d, mint, cutoff, any_hit, with_visits)
    if o.device.type != "cuda":
        raise ValueError(f"isect_bvh runs on cpu or cuda tensors, got {o.device}")
    _check_rays(o, d, mint, cutoff)
    _check_tree(bvh, 40, o.device)
    o, d, mint, cutoff = (x.contiguous() for x in (o, d, mint, cutoff))
    n = o.shape[0]
    out = _outputs(n, o.device)
    visits = torch.empty((2, n), dtype=torch.int32, device=o.device) if with_visits else None
    if n == 0:
        return (*out, visits) if with_visits else out
    next_ray = torch.zeros(1, dtype=torch.int32, device=o.device)
    _launch("isect_bvh_launch", "isect_bvh_any" if any_hit else "isect_bvh_closest",
            _ptr(pairs), _ptr(leaf), _ptr(o), _ptr(d), _ptr(mint), _ptr(cutoff), n,
            int(any_hit), *(_ptr(x) for x in out), _ptr(visits), _ptr(next_ray),
            device=o.device)
    return (*out, visits) if with_visits else out


def last_launch(kernel: str = "bvh") -> dict:
    """The grid, block size and resident blocks per SM of the last
    `isect_bvh` (or, with kernel="brute", `isect_brute`) launch in this
    process (needs the built library)."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    getattr(_build.load(), f"isect_{kernel}_last_launch")(*(ctypes.byref(v) for v in vals))
    return dict(zip(("blocks", "threads", "blocks_per_sm"), (v.value for v in vals)))


def rcp_check(device) -> dict:
    """The sweep's in-line reciprocal (csrc/walk.cuh: rcp_fast) against the
    compiler's `1.0f / x` on every float of 2^-126 <= |x| < 2^126, on the
    card: {"tested": floats, "differ": floats whose bits differ}."""
    counts = torch.zeros(2, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _build.load().isect_rcp_check_launch(_ptr(counts), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"rcp check launch failed: cudaError {rc} ({_build.error_string(rc)})")
    tested, differ = counts.tolist()
    return {"tested": tested, "differ": differ}


def isect_brute(tri, o, d, mint, cutoff):
    """Closest hit of the rays against every triangle of `tri` [T,9] float32,
    v0 | e1 | e2 per row (`scene.data.Geometry.tri_table`). The inputs are
    checked on either device; a CPU tensor then runs `mt_sweep_ref`."""
    if o.device.type not in ("cpu", "cuda"):
        raise ValueError(f"isect_brute runs on cpu or cuda tensors, got {o.device}")
    refuse_graph("isect_brute", tri, o, d, mint, cutoff)
    _check_rays(o, d, mint, cutoff)
    t_cnt = tri.shape[0] if tri.dim() == 2 else -1
    if not 0 < t_cnt < 2**31 // 9:
        raise ValueError(f"isect_brute takes 1 to {2**31 // 9 - 1} triangles as [T, 9], got "
                         f"{tuple(tri.shape)}")
    if (tri.shape != (t_cnt, 9) or tri.dtype != torch.float32 or tri.device != o.device
            or not tri.is_contiguous()):
        raise ValueError(f"tri must be a contiguous float32 [T, 9] tensor on {o.device}")
    if o.device.type == "cpu":
        return mt_sweep_ref(o, d, mint, cutoff, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
    o, d, mint, cutoff = (x.contiguous() for x in (o, d, mint, cutoff))
    n = o.shape[0]
    out = _outputs(n, o.device)
    if n == 0:
        return out
    # 16-byte aligned rays are read as vector loads, else one float at a time
    vec = all(x.data_ptr() % 16 == 0 for x in (o, d, mint, cutoff, *out))
    _launch("isect_brute_launch", "isect_brute", _ptr(tri), t_cnt, _ptr(o),
            _ptr(d), _ptr(mint), _ptr(cutoff), n, int(vec), *(_ptr(x) for x in out),
            device=o.device)
    return out
