"""The LBVH build on the card: the wrapper of `csrc/lbvh.cu`.

Counterpart of the JAX package's `native/` module (`native/lbvh.py:35
build`, the ctypes wrapper of the OpenMP C++ builder `native/lbvh.cpp:60
lbvh_build`), which builds on the host. `lbvh_build` runs the chain of
`csrc/lbvh.cu` on torch's current stream, with the chain's two sorts as
`torch.sort` calls between its three entry points, and no host sync: every
size it needs follows from the primitive count.

Its plain version is the numpy builder of `ops/bvh.py` (`build_bvh_tables`
/ `build_sphere_tables`, then `pack_child_pairs` and `pairs_depth`), which
its tables equal bit for bit; `ops/bvh.py: build_bvh` / `build_sphere_bvh`
take one or the other by device. This wrapper refuses CPU tensors. It adds
one to the counter `launch.lbvh_build` (`utils/tracing.py`) per chain it
launches, and nowhere else; each call is the span `scene.lbvh`.
"""

from __future__ import annotations

import ctypes

import torch

from optix_renderer_tpu_torch.ops.bvh import LEAF_SIZE, PAIR_COLS, lbvh_depth, lbvh_levels
from optix_renderer_tpu_torch.ops.cuda import _build
from optix_renderer_tpu_torch.utils import tracing


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr()) if t is not None else ctypes.c_void_p(0)


def _check(rc: int, entry: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{entry} failed: cudaError {rc} ({_build.error_string(rc)})")


@tracing.traced("scene.lbvh")
def lbvh_build(v0, v1, v2, radius=None):
    """LBVH over n primitives on the card → (packed [Nn, 8], leaf, pairs
    [n_pairs, 16] float32 tensors on the inputs' device, depth int).

    Triangles: v0, v1, v2 [n, 3] float32 are the corners, and leaf is
    [n_leaves, 40] (per slot v0, e1 = v1 − v0, e2 = v2 − v0, id bits).
    Spheres: v0, v1, v2 = c − r, c + r, c and radius [n], and leaf is
    [n_leaves, 20] (per slot centre, radius, id bits). depth is the tree's
    `pairs_depth`, in closed form (`ops/bvh.py: lbvh_depth`).
    """
    dev = v0.device
    if dev.type != "cuda":
        raise ValueError(f"lbvh_build runs on cuda tensors, got {dev}: the numpy builder "
                         "(ops/bvh.py: build_bvh_tables) is the CPU's")
    n = v0.shape[0] if v0.dim() == 2 else -1
    for name, x in (("v0", v0), ("v1", v1), ("v2", v2)):
        if tuple(x.shape) != (n, 3) or x.dtype != torch.float32 or x.device != dev:
            raise ValueError(f"{name} must be float32 [n, 3] on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if radius is not None and (tuple(radius.shape) != (n,) or radius.dtype != torch.float32
                               or radius.device != dev):
        raise ValueError(f"radius must be float32 [{n}] on {dev}")
    if not 0 < n < 2**31 - LEAF_SIZE:
        raise ValueError(f"lbvh_build takes 1 to {2**31 - LEAF_SIZE - 1} primitives, got {n}")
    v0, v1, v2 = (x.detach().contiguous() for x in (v0, v1, v2))
    if radius is not None:
        radius = radius.detach().contiguous()
    n_leaves = -(-n // LEAF_SIZE)
    n_nodes = 2 * n_leaves - 1
    i64 = dict(dtype=torch.int64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cent = torch.empty((n, 3), **f32)
    bounds = torch.empty(6, dtype=torch.int32, device=dev)
    keys = torch.empty(n, **i64)
    packed = torch.empty((n_nodes, 8), **f32)
    leaf = torch.empty((n_leaves, LEAF_SIZE * (10 if radius is None else 5)), **f32)
    pkey = torch.empty(n_nodes, **i64)
    row_of = torch.empty(n_nodes, dtype=torch.int32, device=dev)
    pairs = torch.empty((max(n_leaves - 1, 1), PAIR_COLS), **f32)
    lib = _build.load()

    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        _check(lib.lbvh_keys_launch(_ptr(v0), _ptr(v1), _ptr(v2), n, _ptr(cent), _ptr(bounds),
                                    _ptr(keys), stream), "lbvh_keys_launch")
        # unique keys: any sort gives np.argsort(kind="stable")'s order
        sorted_keys = torch.sort(keys).values
        _check(lib.lbvh_tree_launch(_ptr(v0), _ptr(v1), _ptr(v2), _ptr(radius), n,
                                    _ptr(sorted_keys), _ptr(packed), _ptr(leaf), _ptr(pkey),
                                    lbvh_levels(n_leaves), stream), "lbvh_tree_launch")
        # the pair rows' order, (level, preorder index): glue, not the kernel
        order = torch.sort(pkey).values if n_leaves > 1 else pkey
        _check(lib.lbvh_pairs_launch(_ptr(packed), _ptr(order), _ptr(row_of), n_leaves,
                                     _ptr(pairs), stream), "lbvh_pairs_launch")
    tracing.count("launch.lbvh_build")
    return packed, leaf, pairs, lbvh_depth(n_leaves)
