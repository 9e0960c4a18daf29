"""LBVH for large triangle meshes: numpy build, packing, plain torch walk.

Counterpart of `optix_renderer_tpu/ops/bvh.py` (which imports JAX, so the
port keeps its own copy). The build is the JAX package's numpy builder
(`build_lbvh_numpy`, bvh.py:176-255): triangles sorted by the 30-bit Morton
code of their centroid, `LEAF_SIZE` per leaf, a median-split tree over the
leaves in DFS preorder with skip (escape) links, so a walk keeps one int32
cursor and no stack. The walk reads two packed tables:

* `packed [Nn, 8]` — min(3) | max(3) | skip bits | first bits per node; the
  two links are int32 bits stored in the float32 row (read them by bit
  cast, never by conversion);
* `leaf [n_leaves, 40]` — per slot v0(3) e1(3) e2(3) id bits(1); pad slots
  have id −1 and e1 = e2 = 0.

`traverse_walk_ref` is the plain torch version of the walk
(`_traverse_walk`, bvh.py:396-471); `ops/cuda/isect.py` holds the CUDA
kernel with the same contract, and `replay_tri` recomputes (t, u, v) of the
winner from the live triangle arrays (the detach-and-replay contract).
"""

from __future__ import annotations

import numpy as np
import torch

LEAF_SIZE = 4
# below this many triangles the brute-force sweep is used (bvh.py:43)
MIN_TRIS_FOR_BVH = 257
# the JAX package builds a sphere LBVH from this many spheres (bvh.py:48)
MIN_SPHS_FOR_BVH = 65
BIG = 3.4e38


# ---------------------------------------------------------------------------
# host-side build (numpy)
# ---------------------------------------------------------------------------


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so they occupy every 3rd bit."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3d(p01: np.ndarray) -> np.ndarray:
    """30-bit Morton code of points normalized to [0,1]^3. p01: [N,3]."""
    q = np.clip(p01 * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return ((_expand_bits(q[:, 0]) << np.uint32(2))
            | (_expand_bits(q[:, 1]) << np.uint32(1))
            | _expand_bits(q[:, 2]))


def build_lbvh_numpy(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                     leaf_size: int = LEAF_SIZE):
    """Threaded LBVH over the triangles → (node_min, node_max, skip, first, prim).

    A node over leaf range [lo,hi) sits at preorder slot i with children
    left = i+1 over [lo,mid) and right = i+2(mid−lo) over [mid,hi); a subtree
    over k leaves has 2k−1 nodes, so each level is one numpy operation.
    """
    n = v0.shape[0]
    assert n > 0
    tmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = 0.5 * (tmin + tmax)
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    codes = morton3d((centroid - lo) / extent)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    n_leaves = (n + leaf_size - 1) // leaf_size
    prim = np.full(n_leaves * leaf_size, -1, np.int32)
    prim[:n] = order

    leaf_min = np.full((n_leaves, 3), np.inf, np.float32)
    leaf_max = np.full((n_leaves, 3), -np.inf, np.float32)
    leaf_of = np.repeat(np.arange(n_leaves), leaf_size)[:n]
    np.minimum.at(leaf_min, leaf_of, tmin[order])
    np.maximum.at(leaf_max, leaf_of, tmax[order])

    n_nodes = 2 * n_leaves - 1
    node_min = np.zeros((n_nodes, 3), np.float32)
    node_max = np.zeros((n_nodes, 3), np.float32)
    skip = np.zeros(n_nodes, np.int32)
    first = np.full(n_nodes, -1, np.int32)

    levels = []  # (idx, lo, hi) per level, root → leaves
    idx_l = np.array([0], np.int64)
    lo_l = np.array([0], np.int64)
    hi_l = np.array([n_leaves], np.int64)
    skip[0] = n_nodes
    while len(idx_l):
        levels.append((idx_l, lo_l, hi_l))
        interior = (hi_l - lo_l) > 1
        if not interior.any():
            break
        ii, lo, hi = idx_l[interior], lo_l[interior], hi_l[interior]
        mid = (lo + hi) // 2
        li, ri = ii + 1, ii + 2 * (mid - lo)
        # left child's escape = right child; right child inherits the parent's
        skip[li] = ri
        skip[ri] = skip[ii]
        idx_l = np.concatenate([li, ri])
        lo_l = np.concatenate([lo, mid])
        hi_l = np.concatenate([mid, hi])

    all_idx = np.concatenate([lv[0] for lv in levels])
    all_lo = np.concatenate([lv[1] for lv in levels])
    all_hi = np.concatenate([lv[2] for lv in levels])
    is_leaf_node = all_hi - all_lo == 1
    leaf_nodes = all_idx[is_leaf_node]
    leaf_ranges = all_lo[is_leaf_node]
    first[leaf_nodes] = (leaf_ranges * leaf_size).astype(np.int32)
    node_min[leaf_nodes] = leaf_min[leaf_ranges]
    node_max[leaf_nodes] = leaf_max[leaf_ranges]

    # interior boxes: deepest level first, so children come before parents
    for idx_l, lo_l, hi_l in reversed(levels):
        interior = (hi_l - lo_l) > 1
        if not interior.any():
            continue
        ii, lo, hi = idx_l[interior], lo_l[interior], hi_l[interior]
        mid = (lo + hi) // 2
        li, ri = ii + 1, ii + 2 * (mid - lo)
        node_min[ii] = np.minimum(node_min[li], node_min[ri])
        node_max[ii] = np.maximum(node_max[li], node_max[ri])

    return node_min, node_max, skip, first, prim


def _pack_nodes(node_min, node_max, skip, first) -> np.ndarray:
    """[Nn,8]: min(3) | max(3) | skip bits | first bits."""
    packed = np.empty((node_min.shape[0], 8), np.float32)
    packed[:, 0:3] = node_min
    packed[:, 3:6] = node_max
    packed[:, 6] = skip.astype(np.int32).view(np.float32)
    packed[:, 7] = first.astype(np.int32).view(np.float32)
    return packed


def _pack_tri_leaves(prim, v0, e1, e2, leaf_size: int) -> np.ndarray:
    """[n_leaves, leaf_size*10]: per slot v0(3) e1(3) e2(3) id bits(1).

    Pad slots (id −1) carry e1 = e2 = 0, so Möller–Trumbore's det test
    rejects them."""
    n_leaves = prim.shape[0] // leaf_size
    ids = prim.reshape(n_leaves, leaf_size)
    gid = np.maximum(ids, 0)
    slot = np.empty((n_leaves, leaf_size, 10), np.float32)
    valid = (ids >= 0)[..., None]
    slot[:, :, 0:3] = v0[gid]
    slot[:, :, 3:6] = np.where(valid, e1[gid], 0.0)
    slot[:, :, 6:9] = np.where(valid, e2[gid], 0.0)
    slot[:, :, 9] = ids.astype(np.int32).view(np.float32)
    return slot.reshape(n_leaves, leaf_size * 10)


def build_bvh_tables(v0, v1, v2) -> tuple[np.ndarray, np.ndarray]:
    """Host build → (packed [Nn,8], leaf [n_leaves,40]) float32 numpy."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    node_min, node_max, skip, first, prim = build_lbvh_numpy(v0, v1, v2)
    return (_pack_nodes(node_min, node_max, skip, first),
            _pack_tri_leaves(prim, v0, v1 - v0, v2 - v0, LEAF_SIZE))


# ---------------------------------------------------------------------------
# per-lane arithmetic shared by the walk, the sweep and the replay
# ---------------------------------------------------------------------------


def mt_lanes(o, d, v0, e1, e2):
    """Möller–Trumbore per lane (all [..., 3]) → (t, u, v, hit) each [...].

    No backface culling, inclusive edges (mesh.cpp:61-97); the component
    order is the CUDA kernels' (`csrc/isect.cu: mt`)."""
    px = d[..., 1] * e2[..., 2] - d[..., 2] * e2[..., 1]
    py = d[..., 2] * e2[..., 0] - d[..., 0] * e2[..., 2]
    pz = d[..., 0] * e2[..., 1] - d[..., 1] * e2[..., 0]
    det = e1[..., 0] * px + e1[..., 1] * py + e1[..., 2] * pz
    det_ok = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(det_ok, det, 1e-12)
    tx = o[..., 0] - v0[..., 0]
    ty = o[..., 1] - v0[..., 1]
    tz = o[..., 2] - v0[..., 2]
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1[..., 2] - tz * e1[..., 1]
    qy = tz * e1[..., 0] - tx * e1[..., 2]
    qz = tx * e1[..., 1] - ty * e1[..., 0]
    v = (d[..., 0] * qx + d[..., 1] * qy + d[..., 2] * qz) * inv_det
    t = (e2[..., 0] * qx + e2[..., 1] * qy + e2[..., 2] * qz) * inv_det
    hit = det_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, hit


def replay_tri(o, d, v0, e1, e2):
    """Per-lane single-triangle Möller–Trumbore (all [N,3] → t, u, v [N]).

    Recomputes the winner that a walk or sweep selected from the live
    triangle arrays, with the same arithmetic as the selection."""
    t, u, v, _ = mt_lanes(o, d, v0, e1, e2)
    return t, u, v


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/d with components of magnitude ≤ 1e-20 replaced by 1e-20 (bvh.py:417)."""
    return 1.0 / torch.where(torch.abs(d) > 1e-20, d, 1e-20)


def _slab(o, inv_d, bmin, bmax, tmin, tmax):
    """Ray–AABB slab test (bbox.h), [M,3] / [M] → hit mask [M]."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    near = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    far = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return (near <= far) & (far >= tmin) & (near <= tmax)


def traverse_walk_ref(packed, leaf, o, d, mint, cutoff, any_hit: bool = False,
                      with_visits: bool = False):
    """Plain torch stackless walk of the packed LBVH (bvh.py:396-471).

    o, d: [N,3]; mint, cutoff: [N] float32 (cutoff is the initial far clip).
    Returns (id [N] int32, −1 on a miss; t, u, v [N]), plus, when
    `with_visits`, [2, N] int32: the nodes visited and the leaves tested per
    ray. Each step reads one node row; a leaf
    whose box is hit tests its four slots in order with strict `<` against
    the running best (the argmin-first tie-break). With `any_hit` a ray
    stops at its first confirmed hit. Only the rays still walking are
    carried from one step to the next.
    """
    n = o.shape[0]
    dev = o.device
    n_nodes = packed.shape[0]
    links = packed[:, 6:8].contiguous().view(torch.int32)  # skip, first
    out_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_t = cutoff.clone()
    out_u = torch.zeros(n, dtype=torch.float32, device=dev)
    out_v = torch.zeros(n, dtype=torch.float32, device=dev)
    visits = torch.zeros((2, n), dtype=torch.int32, device=dev)

    lane = torch.arange(n, device=dev)
    ro, rd, rmint = o, d, mint
    inv_d = safe_inv_dir(d)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    best_t, best_u, best_v = cutoff.clone(), out_u.clone(), out_v.clone()
    best_id = out_id.clone()
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    while lane.numel():
        visits[0, lane] += 1
        row = packed[node]
        skip, fi = links[node, 0].long(), links[node, 1].long()
        hit_box = _slab(ro, inv_d, row[:, 0:3], row[:, 3:6], rmint, best_t)
        is_leaf = fi >= 0
        do_leaf = hit_box & is_leaf
        if bool(do_leaf.any()):
            k = do_leaf.nonzero().squeeze(1)
            visits[1, lane[k]] += 1
            slots = leaf[fi[k] // LEAF_SIZE].reshape(-1, LEAF_SIZE, 10)
            pids = slots[..., 9].contiguous().view(torch.int32)
            ko, kd, kmint = ro[k], rd[k], rmint[k]
            bt, bu, bv, bi = best_t[k], best_u[k], best_v[k], best_id[k]
            hit_any = found[k]
            for j in range(LEAF_SIZE):
                t, u, v, h = mt_lanes(ko, kd, slots[:, j, 0:3], slots[:, j, 3:6],
                                      slots[:, j, 6:9])
                better = h & (pids[:, j] >= 0) & (t >= kmint) & (t < bt)
                bt = torch.where(better, t, bt)
                bu = torch.where(better, u, bu)
                bv = torch.where(better, v, bv)
                bi = torch.where(better, pids[:, j], bi)
                hit_any = hit_any | better
            best_t[k], best_u[k], best_v[k], best_id[k], found[k] = bt, bu, bv, bi, hit_any
        nxt = torch.where(hit_box & ~is_leaf, node + 1, skip)
        if any_hit:
            nxt = torch.where(found, n_nodes, nxt)
        done = nxt >= n_nodes
        if bool(done.any()):
            dl = lane[done]
            out_t[dl], out_u[dl], out_v[dl] = best_t[done], best_u[done], best_v[done]
            out_id[dl] = best_id[done]
            keep = ~done
            lane, node = lane[keep], nxt[keep]
            ro, rd, rmint, inv_d = ro[keep], rd[keep], rmint[keep], inv_d[keep]
            best_t, best_u, best_v = best_t[keep], best_u[keep], best_v[keep]
            best_id, found = best_id[keep], found[keep]
        else:
            node = nxt
    if with_visits:
        return out_id, out_t, out_u, out_v, visits
    return out_id, out_t, out_u, out_v
