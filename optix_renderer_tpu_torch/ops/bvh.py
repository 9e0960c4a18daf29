"""LBVH for large triangle meshes: the builds, packing, plain torch walk.

Counterpart of `optix_renderer_tpu/ops/bvh.py` (which imports JAX, so the
port keeps its own copy). The tree is the JAX package's
(`build_lbvh_numpy`, bvh.py:176-255): triangles sorted by the 30-bit Morton
code of their centroid, `LEAF_SIZE` per leaf, a median-split tree over the
leaves in DFS preorder with skip (escape) links, so a walk keeps one int32
cursor and no stack.

`build_bvh` / `build_sphere_bvh` (after the JAX functions of those names)
build it on a device: on CUDA by the chain of `csrc/lbvh.cu`
(`ops/cuda/lbvh.py: lbvh_build`, the counterpart of the JAX package's C++
builder `native/lbvh.cpp`), on the CPU by the numpy builder here
(`build_bvh_tables` / `build_sphere_tables` + `pack_child_pairs`), which is
the kernel's plain version: the two give the same tables bit for bit. Both
follow numpy's tie rule for min / max (ties keep the second operand); the
JAX C++ builder's `std::min` keeps the first, so its boxes can differ from
both in the sign of a zero bound. The walk reads two packed tables:

* `packed [Nn, 8]` — min(3) | max(3) | skip bits | first bits per node; the
  two links are int32 bits stored in the float32 row (read them by bit
  cast, never by conversion);
* `leaf [n_leaves, 40]` — per slot v0(3) e1(3) e2(3) id bits(1); pad slots
  have id −1 and e1 = e2 = 0.

`traverse_walk_ref` is the plain torch version of that walk
(`_traverse_walk`, bvh.py:396-471) and of `csrc/walk.cuh`, which the path
kernel's medium branch runs (`ops/cuda/pathk.py`).

The general path's kernel (`csrc/isect.cu`, wrapper `ops/cuda/isect.py:
isect_bvh`) reads the same tree as a third table, `pairs [n_pairs, 16]`
(`pack_child_pairs`): one row per interior node holding both children's
boxes and references, walked nearest child first from a short stack;
`traverse_pairs_ref` is its plain version. `replay_tri` recomputes
(t, u, v) of the winner from the live triangle arrays (the
detach-and-replay contract).

Scenes of `MIN_SPHS_FOR_BVH` spheres or more get a second LBVH over the
spheres (`build_sphere_tables`, bvh.py:276-297): the same builder on each
sphere's box, leaf rows of `[n_leaves, 20]` (per slot center(3), radius,
id bits). `traverse_spheres_ref` is the plain version of its skip-link walk
(`_traverse_spheres_walk`, bvh.py:545-597) and of the kernel
`csrc/isect.cu: isect_spheres`, which walks the same tree as child pairs;
`replay_sphere` recomputes the winner's t live.
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
# a child-pair row: left box min(3) max(3) | right box min(3) max(3) |
# left ref, right ref (int32 bits) | 2 pad; a ref >= 0 is a pair row, a ref
# < 0 is the leaf row ~ref
PAIR_COLS = 16
# entries of the pair walk's per-ray stack (csrc/isect.cu: STACK_DEPTH); a
# tree of more levels (`pairs_depth`) is refused
STACK_DEPTH = 24


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


def _pack_sphere_leaves(prim, center, radius, leaf_size: int) -> np.ndarray:
    """[n_leaves, leaf_size*5]: per slot center(3) radius(1) id bits(1).

    Pad slots (id −1) are rejected by the walk's id mask; their radius is 0
    only to keep the arithmetic finite."""
    n_leaves = prim.shape[0] // leaf_size
    ids = prim.reshape(n_leaves, leaf_size)
    gid = np.maximum(ids, 0)
    slot = np.empty((n_leaves, leaf_size, 5), np.float32)
    slot[:, :, 0:3] = center[gid]
    slot[:, :, 3] = np.where(ids >= 0, radius[gid], 0.0)
    slot[:, :, 4] = ids.astype(np.int32).view(np.float32)
    return slot.reshape(n_leaves, leaf_size * 5)


def build_sphere_tables(center, radius) -> tuple[np.ndarray, np.ndarray]:
    """LBVH over analytic spheres → (packed [Nn,8], leaf [n_leaves,20])
    float32 numpy, bit for bit the JAX `build_sphere_bvh`'s tables: the
    triangle builder on the corners (c − r, c + r, c), which span exactly
    each sphere's box."""
    c = np.asarray(center, np.float32)
    r = np.asarray(radius, np.float32)
    node_min, node_max, skip, first, prim = build_lbvh_numpy(c - r[:, None], c + r[:, None], c)
    return (_pack_nodes(node_min, node_max, skip, first),
            _pack_sphere_leaves(prim, c, r, LEAF_SIZE))


def build_bvh_tables(v0, v1, v2) -> tuple[np.ndarray, np.ndarray]:
    """Host build → (packed [Nn,8], leaf [n_leaves,40]) float32 numpy."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    node_min, node_max, skip, first, prim = build_lbvh_numpy(v0, v1, v2)
    return (_pack_nodes(node_min, node_max, skip, first),
            _pack_tri_leaves(prim, v0, v1 - v0, v2 - v0, LEAF_SIZE))


def build_bvh_tables_from_edges(v0, e1, e2) -> tuple[np.ndarray, np.ndarray]:
    """`build_bvh_tables` for triangles held as v0 | e1 | e2.

    The boxes and Morton codes come from the corners v0 + e1 and v0 + e2;
    the leaf slots carry e1 and e2 as given, so they equal the tables that
    were packed from them bit for bit (recomputing (v0 + e1) − v0 would
    round)."""
    v0, e1, e2 = (np.asarray(x, np.float32) for x in (v0, e1, e2))
    node_min, node_max, skip, first, prim = build_lbvh_numpy(v0, v0 + e1, v0 + e2)
    return (_pack_nodes(node_min, node_max, skip, first),
            _pack_tri_leaves(prim, v0, e1, e2, LEAF_SIZE))


def pack_child_pairs(packed) -> np.ndarray:
    """The skip-link table `packed [Nn, 8]` → child pairs [n_pairs, 16] float32.

    One row per interior node, breadth first (the root's row is row 0, and
    each level's rows follow the level above, left before right): the boxes
    of its children `i + 1` and `skip[i + 1]` copied bit for bit, then their
    references as int32 bits (a pair row, or `~leaf_row` for a leaf, whose
    slots start at `first // LEAF_SIZE`). The tree is the same one. A tree
    whose root is a leaf gets one row with that leaf on the left and an
    empty right slot: a NaN box, which no slab test hits, and ref ~0."""
    packed = np.asarray(packed, np.float32)
    links = np.ascontiguousarray(packed[:, 6:8]).view(np.int32)
    skip, first = links[:, 0], links[:, 1]
    ref_bits = lambda r: np.asarray(r, np.int32).view(np.float32)
    if first[0] >= 0:
        row = np.full((1, PAIR_COLS), np.nan, np.float32)
        row[0, 0:6] = packed[0, 0:6]
        row[0, 12:16] = ref_bits([~(first[0] // LEAF_SIZE), ~0, 0, 0])
        return row
    levels, frontier = [], np.array([0], np.int64)
    while frontier.size:
        levels.append(frontier)
        kids = np.stack([frontier + 1, skip[frontier + 1]], axis=1).ravel()
        frontier = kids[first[kids] < 0]
    interior = np.concatenate(levels)
    row_of = np.full(packed.shape[0], -1, np.int64)
    row_of[interior] = np.arange(interior.size)
    pairs = np.zeros((interior.size, PAIR_COLS), np.float32)
    for side, child in enumerate((interior + 1, skip[interior + 1])):
        pairs[:, 6 * side:6 * side + 6] = packed[child, 0:6]
        pairs[:, 12 + side] = ref_bits(np.where(first[child] >= 0, ~(first[child] // LEAF_SIZE),
                                                row_of[child]))
    return pairs


def pairs_depth(pairs) -> int:
    """Levels of the tree that a child-pair table holds: pair rows on its
    longest path from row 0, plus one for the leaf. A walk pushes at most one
    entry per pair row on its path, so its stack needs fewer entries."""
    refs = np.ascontiguousarray(np.asarray(pairs, np.float32)[:, 12:14]).view(np.int32)
    depth, frontier = 1, np.array([0], np.int64)
    while frontier.size:
        depth += 1
        kids = refs[frontier].ravel()
        frontier = kids[kids >= 0].astype(np.int64)
    return depth


def lbvh_levels(n_leaves: int) -> int:
    """Levels of the median-split tree over `n_leaves` leaves, root and
    leaves included: the larger half has ⌈k/2⌉ leaves, so 1 + ⌈log2 k⌉."""
    return 1 + (n_leaves - 1).bit_length()


def lbvh_depth(n_leaves: int) -> int:
    """`pairs_depth` of that tree in closed form; a root that is a leaf
    still has its one pair row, so at least 2."""
    return max(2, lbvh_levels(n_leaves))


def _host_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _device_f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def _host_bvh(packed: np.ndarray, leaf: np.ndarray):
    from optix_renderer_tpu_torch.scene.data import Bvh

    pairs = pack_child_pairs(packed)
    return Bvh(packed=torch.from_numpy(packed), leaf=torch.from_numpy(leaf),
               pairs=torch.from_numpy(pairs), depth=pairs_depth(pairs))


def _device_bvh(device, v0, v1, v2, radius=None):
    from optix_renderer_tpu_torch.ops.cuda.lbvh import lbvh_build
    from optix_renderer_tpu_torch.scene.data import Bvh

    packed, leaf, pairs, depth = lbvh_build(v0, v1, v2, radius)
    return Bvh(packed=packed, leaf=leaf, pairs=pairs, depth=depth)


def build_bvh(v0, v1, v2, device):
    """The triangles' LBVH (corners v0, v1, v2 [T, 3], numpy or tensors) →
    `scene.data.Bvh` on `device`: on CUDA built by `csrc/lbvh.cu`, on the
    CPU by `build_bvh_tables` + `pack_child_pairs`; the same tables."""
    device = torch.device(device)
    if device.type == "cuda":
        return _device_bvh(device, *(_device_f32(x, device) for x in (v0, v1, v2)))
    if device.type != "cpu":
        raise ValueError(f"build_bvh builds on cpu or cuda, got {device}")
    return _host_bvh(*build_bvh_tables(*(_host_f32(x) for x in (v0, v1, v2))))


def build_sphere_bvh(center, radius, device):
    """The spheres' LBVH (center [S, 3], radius [S]) → `scene.data.Bvh` on
    `device`: on CUDA `csrc/lbvh.cu` over (c − r, c + r, c), on the CPU
    `build_sphere_tables` + `pack_child_pairs`; the same tables."""
    device = torch.device(device)
    if device.type == "cuda":
        c, r = _device_f32(center, device), _device_f32(radius, device)
        return _device_bvh(device, c - r[:, None], c + r[:, None], c, r)
    if device.type != "cpu":
        raise ValueError(f"build_sphere_bvh builds on cpu or cuda, got {device}")
    return _host_bvh(*build_sphere_tables(_host_f32(center), _host_f32(radius)))


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


def sphere_roots(o, d, center, radius, disc_floor: float = 0.0):
    """Stable quadratic of the ray–sphere test (sphere.cpp:67-124), per lane
    (all [..., 3] / [...]) → (near t, far t, disc ≥ 0). The sums are taken
    component by component in the order of `csrc/isect.cu: sphere_roots`,
    so the kernel's t equal these; the discriminant is floored at
    `disc_floor` before its square root."""
    ocx, ocy, ocz = (o[..., k] - center[..., k] for k in range(3))
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    a = dx * dx + dy * dy + dz * dz
    b = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    c = (ocx * ocx + ocy * ocy + ocz * ocz) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=disc_floor))
    q = -0.5 * (b + torch.sign(b) * sq)
    t0 = q / a
    t1 = c / torch.where(torch.abs(q) > 1e-20, q, 1e-20)
    return torch.minimum(t0, t1), torch.maximum(t0, t1), disc >= 0.0


def replay_sphere(o, d, center, radius, t_det):
    """Differentiable one-sphere replay (bvh.py:497-514): the root of the
    stable quadratic that the detached walk selected, near or far by
    proximity to `t_det` (a discrete choice, so detached). o, d, center
    [N,3]; radius, t_det [N] → t [N]."""
    tn, tf, _ = sphere_roots(o, d, center, radius, disc_floor=1e-20)
    pick_near = (torch.abs(tn - t_det) <= torch.abs(tf - t_det)).detach()
    return torch.where(pick_near, tn, tf)


def safe_inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/d with components of magnitude ≤ 1e-20 replaced by 1e-20 (bvh.py:417)."""
    return 1.0 / torch.where(torch.abs(d) > 1e-20, d, 1e-20)


def _slab_near(o, inv_d, bmin, bmax, tmin, tmax):
    """Ray–AABB slab test (bbox.h), [M,3] / [M] → (hit mask [M], near t [M])."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    near = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    far = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return (near <= far) & (far >= tmin) & (near <= tmax), near


def _slab(o, inv_d, bmin, bmax, tmin, tmax):
    """Ray–AABB slab test (bbox.h), [M,3] / [M] → hit mask [M]."""
    return _slab_near(o, inv_d, bmin, bmax, tmin, tmax)[0]


def _test_leaves(leaf, rows, o, d, mint, bt, bu, bv, bi, lowest_id):
    """The four slots of leaf rows `rows` [k] against rays [k], in slot order
    with strict `<` against the running best (bt, bu, bv, bi) (the
    argmin-first tie-break), or with `lowest_id` also taking an equal t
    from a smaller triangle id. Returns the new best and whether a slot
    was taken. The slots are tested in one broadcast ([k, 1, 3] rays
    against [k, LEAF_SIZE, 3] slots: the same arithmetic per pair)."""
    slots = leaf[rows].reshape(-1, LEAF_SIZE, 10)
    pids = slots[..., 9].contiguous().view(torch.int32)
    t, u, v, h = mt_lanes(o[:, None], d[:, None], slots[..., 0:3], slots[..., 3:6],
                          slots[..., 6:9])
    ok = h & (pids >= 0) & (t >= mint[:, None])
    took = torch.zeros_like(ok[:, 0])
    for j in range(LEAF_SIZE):
        tj, pj = t[:, j], pids[:, j]
        closer = (tj < bt) | ((tj == bt) & (pj < bi)) if lowest_id else tj < bt
        better = ok[:, j] & closer
        bt = torch.where(better, tj, bt)
        bu = torch.where(better, u[:, j], bu)
        bv = torch.where(better, v[:, j], bv)
        bi = torch.where(better, pj, bi)
        took = took | better
    return bt, bu, bv, bi, took


def traverse_walk_ref(packed, leaf, o, d, mint, cutoff, any_hit=False,
                      with_visits: bool = False, lowest_id: bool = False):
    """Plain torch stackless walk of the packed LBVH (bvh.py:396-471).

    o, d: [N,3]; mint, cutoff: [N] float32 (cutoff is the initial far clip).
    Returns (id [N] int32, −1 on a miss; t, u, v [N]), plus, when
    `with_visits`, [2, N] int32: the nodes visited and the leaves tested per
    ray. Each step reads one node row; a leaf whose box is hit tests its
    four slots (`_test_leaves`: the first of equal t wins, or with
    `lowest_id` the smaller triangle id, a sweep's lowest-index minimum: the
    path kernel's medium branch). With `any_hit` (a bool, or a bool [N] per
    ray) a ray stops at its first confirmed hit. Only the rays still walking
    are carried from one step to the next.
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
    stop = (any_hit.to(device=dev, dtype=torch.bool) if isinstance(any_hit, torch.Tensor)
            else torch.full((n,), bool(any_hit), dtype=torch.bool, device=dev))
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    while lane.numel():
        if with_visits:
            visits[0, lane] += 1
        row = packed[node]
        skip, fi = links[node, 0].long(), links[node, 1].long()
        hit_box = _slab(ro, inv_d, row[:, 0:3], row[:, 3:6], rmint, best_t)
        is_leaf = fi >= 0
        do_leaf = hit_box & is_leaf
        if bool(do_leaf.any()):
            k = do_leaf.nonzero().squeeze(1)
            if with_visits:
                visits[1, lane[k]] += 1
            bt, bu, bv, bi, took = _test_leaves(leaf, fi[k] // LEAF_SIZE, ro[k], rd[k], rmint[k],
                                                best_t[k], best_u[k], best_v[k], best_id[k],
                                                lowest_id)
            best_t[k], best_u[k], best_v[k], best_id[k] = bt, bu, bv, bi
            found[k] = found[k] | took
        nxt = torch.where(hit_box & ~is_leaf, node + 1, skip)
        nxt = torch.where(found & stop, n_nodes, nxt)
        done = nxt >= n_nodes
        if bool(done.any()):
            dl = lane[done]
            out_t[dl], out_u[dl], out_v[dl] = best_t[done], best_u[done], best_v[done]
            out_id[dl] = best_id[done]
            keep = ~done
            lane, node = lane[keep], nxt[keep]
            ro, rd, rmint, inv_d = ro[keep], rd[keep], rmint[keep], inv_d[keep]
            best_t, best_u, best_v = best_t[keep], best_u[keep], best_v[keep]
            best_id, found, stop = best_id[keep], found[keep], stop[keep]
        else:
            node = nxt
    if with_visits:
        return out_id, out_t, out_u, out_v, visits
    return out_id, out_t, out_u, out_v


def traverse_pairs_ref(pairs, leaf, o, d, mint, cutoff, any_hit: bool = False,
                       with_visits: bool = False):
    """Plain torch walk of the child-pair table, the kernel's step for step
    (`csrc/isect.cu: pair_step`).

    pairs [n_pairs, 16] (`pack_child_pairs`), leaf [n_leaves, 40]; o, d
    [N,3]; mint, cutoff [N] float32. Returns what `traverse_walk_ref`
    returns; the `with_visits` rows count the pair rows read and the leaves
    tested per ray. A step reads one pair row and slab-tests both children:
    it goes on to the nearer child that was hit (the left one on equal near
    t) and pushes the other with its near t onto the ray's stack
    ([N, STACK_DEPTH] with a stack pointer), or it tests one leaf's four
    slots (the smaller triangle id wins on equal t, so the winner does not
    depend on the visit order: a sweep's lowest-index minimum). Then, when
    the step found no child to go on to, it pops, dropping entries whose
    near t lies past the best t. With `any_hit` a ray stops after the leaf
    of its first confirmed hit. Only the rays still walking are carried from
    one step to the next. Raises if a ray's stack would overflow.
    """
    n = o.shape[0]
    dev = o.device
    refs = pairs[:, 12:14].contiguous().view(torch.int32).long()  # left, right
    out_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_t = cutoff.clone()
    out_u = torch.zeros(n, dtype=torch.float32, device=dev)
    out_v = torch.zeros(n, dtype=torch.float32, device=dev)
    visits = torch.zeros((2, n), dtype=torch.int32, device=dev)

    lane = torch.arange(n, device=dev)
    ro, rd, rmint = o, d, mint
    inv_d = safe_inv_dir(d)
    cur = torch.zeros(n, dtype=torch.int64, device=dev)  # the root's pair row
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    st_ref = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    st_near = torch.zeros((n, STACK_DEPTH), dtype=torch.float32, device=dev)
    best_t, best_u, best_v = cutoff.clone(), out_u.clone(), out_v.clone()
    best_id = out_id.clone()
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    while lane.numel():
        pop = torch.zeros_like(found)
        done = torch.zeros_like(found)
        inner = cur >= 0
        k = inner.nonzero().squeeze(1)
        if k.numel():
            if with_visits:
                visits[0, lane[k]] += 1
            row, rr = pairs[cur[k]], refs[cur[k]]
            hl, nl = _slab_near(ro[k], inv_d[k], row[:, 0:3], row[:, 3:6], rmint[k], best_t[k])
            hr, nr = _slab_near(ro[k], inv_d[k], row[:, 6:9], row[:, 9:12], rmint[k], best_t[k])
            both, rfirst = hl & hr, nr < nl
            kb = k[both]
            if kb.numel():
                if bool((sp[kb] >= STACK_DEPTH).any()):
                    raise ValueError(f"the tree is deeper than the pair walk's stack of "
                                     f"{STACK_DEPTH} entries")
                st_ref[kb, sp[kb]] = torch.where(rfirst, rr[:, 0], rr[:, 1])[both]
                st_near[kb, sp[kb]] = torch.where(rfirst, nl, nr)[both]
                sp[kb] += 1
            nxt = torch.where(both, torch.where(rfirst, rr[:, 1], rr[:, 0]),
                              torch.where(hl, rr[:, 0], rr[:, 1]))
            cur[k] = torch.where(hl | hr, nxt, cur[k])
            pop[k] = ~(hl | hr)
        k = (~inner).nonzero().squeeze(1)
        if k.numel():
            if with_visits:
                visits[1, lane[k]] += 1
            bt, bu, bv, bi, took = _test_leaves(leaf, ~cur[k], ro[k], rd[k], rmint[k], best_t[k],
                                                best_u[k], best_v[k], best_id[k], True)
            best_t[k], best_u[k], best_v[k], best_id[k] = bt, bu, bv, bi
            found[k] = found[k] | took
            stop = found[k] & bool(any_hit)
            done[k], pop[k] = stop, ~stop
        while True:  # pop until an entry lies within the best t, or the stack is empty
            kp = (pop & (sp > 0)).nonzero().squeeze(1)
            if not kp.numel():
                break
            sp[kp] -= 1
            ka = kp[~(st_near[kp, sp[kp]] > best_t[kp])]
            cur[ka] = st_ref[ka, sp[ka]]
            pop[ka] = False
        done |= pop
        if bool(done.any()):
            dl = lane[done]
            out_t[dl], out_u[dl], out_v[dl] = best_t[done], best_u[done], best_v[done]
            out_id[dl] = best_id[done]
            keep = ~done
            lane, cur, sp, st_ref, st_near = (x[keep] for x in (lane, cur, sp, st_ref, st_near))
            ro, rd, rmint, inv_d = ro[keep], rd[keep], rmint[keep], inv_d[keep]
            best_t, best_u, best_v = best_t[keep], best_u[keep], best_v[keep]
            best_id, found = best_id[keep], found[keep]
    if with_visits:
        return out_id, out_t, out_u, out_v, visits
    return out_id, out_t, out_u, out_v


def traverse_spheres_ref(packed, leaf, o, d, mint, cutoff, any_hit: bool = False,
                         with_visits: bool = False):
    """Plain torch skip-link walk of the sphere LBVH (`_traverse_spheres_walk`,
    bvh.py:545-597), in lockstep as `traverse_walk_ref`.

    packed [Nn,8] and leaf [n_leaves,20] (`build_sphere_tables`); o, d
    [N,3]; mint, cutoff [N] float32. Returns (id [N] int32, −1 on a miss;
    t [N], cutoff on a miss), plus, when `with_visits`, [2, N] int32: the
    nodes visited and the leaves tested per ray. A leaf whose box is hit
    takes each slot's nearer root in [mint, best t), else its farther one
    (`sphere_roots`), all against the best t before the leaf; the first
    slot of the least t wins, and only if its t is below the best (strict
    <). With `any_hit` a ray stops after the leaf of its first hit.
    """
    n = o.shape[0]
    dev = o.device
    n_nodes = packed.shape[0]
    links = packed[:, 6:8].contiguous().view(torch.int32)  # skip, first
    out_id = torch.full((n,), -1, dtype=torch.int32, device=dev)
    out_t = cutoff.clone()
    visits = torch.zeros((2, n), dtype=torch.int32, device=dev)

    lane = torch.arange(n, device=dev)
    ro, rd, rmint = o, d, mint
    inv_d = safe_inv_dir(d)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    best_t, best_id = cutoff.clone(), out_id.clone()
    found = torch.zeros(n, dtype=torch.bool, device=dev)
    while lane.numel():
        if with_visits:
            visits[0, lane] += 1
        row = packed[node]
        skip, fi = links[node, 0].long(), links[node, 1].long()
        hit_box = _slab(ro, inv_d, row[:, 0:3], row[:, 3:6], rmint, best_t)
        is_leaf = fi >= 0
        do_leaf = hit_box & is_leaf
        if bool(do_leaf.any()):
            k = do_leaf.nonzero().squeeze(1)
            if with_visits:
                visits[1, lane[k]] += 1
            slots = leaf[fi[k] // LEAF_SIZE].reshape(-1, LEAF_SIZE, 5)
            pids = slots[..., 4].contiguous().view(torch.int32)
            bt = best_t[k]
            tn, tf, ok = sphere_roots(ro[k, None], rd[k, None], slots[..., 0:3], slots[..., 3])
            lo, hi = rmint[k, None], bt[:, None]
            t_cand = torch.where(ok & (tn >= lo) & (tn < hi), tn,
                                 torch.where(ok & (tf >= lo) & (tf < hi), tf, BIG))
            t_cand = torch.where(pids >= 0, t_cand, BIG)
            j = torch.argmin(t_cand, dim=1, keepdim=True)
            tj = t_cand.gather(1, j).squeeze(1)
            better = tj < bt
            best_t[k] = torch.where(better, tj, bt)
            best_id[k] = torch.where(better, pids.gather(1, j).squeeze(1), best_id[k])
            found[k] = found[k] | better
        nxt = torch.where(hit_box & ~is_leaf, node + 1, skip)
        if any_hit:
            nxt = torch.where(found, n_nodes, nxt)
        done = nxt >= n_nodes
        if bool(done.any()):
            dl = lane[done]
            out_t[dl], out_id[dl] = best_t[done], best_id[done]
            keep = ~done
            lane, node = lane[keep], nxt[keep]
            ro, rd, rmint, inv_d = ro[keep], rd[keep], rmint[keep], inv_d[keep]
            best_t, best_id, found = best_t[keep], best_id[keep], found[keep]
        else:
            node = nxt
    if with_visits:
        return out_id, out_t, visits
    return out_id, out_t
