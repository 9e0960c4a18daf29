"""The general path's LBVH walk over child pairs (`ops/bvh.py:
pack_child_pairs`, `traverse_pairs_ref`, the plain version of
`csrc/isect.cu: bvh_kernel`) against the JAX package's walk and the sweep,
on inputs made from a numpy seed.

* `pack_child_pairs` holds the same tree: each row's boxes are the boxes of
  nodes `i + 1` and `skip[i + 1]` bit for bit, its refs reach every pair
  row and every leaf once; a one-leaf tree works;
* closest hit against `bvh._traverse_walk` (JAX, CPU): hit masks equal, ids
  equal where the winning t is not tied bit for bit with another hit's,
  the lower id where it is, t within 1e-6 relative; any hit: masks equal;
* closest-hit ids equal the sweep's (`mt_sweep_ref`), also on built ties
  whose leaf slots put the higher id first;
* a tree deeper than the walk's stack is refused; `isect_bvh` on CPU
  tensors runs the plain version and counts no launch; the scene builders
  carry the table.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.core.math import Ray as JRay
from optix_renderer_tpu.ops import bvh as jbvh
from optix_renderer_tpu_torch.ops import bvh
from optix_renderer_tpu_torch.ops.cuda import isect
from optix_renderer_tpu_torch.scene import presets
from optix_renderer_tpu_torch.scene.data import Bvh, scene_from_numpy

T = torch.from_numpy


def _cornell_tris(nu, nv):
    """The tessellated Cornell box: 12 + 4 nu (nv - 1) triangles."""
    s, _, _ = presets.make_tessellated_cornell(24, 16, 1, nu=nu, nv=nv, device="cpu")
    g = s.geometry
    v0 = g.tri_v0.numpy()
    return v0, v0 + g.tri_e1.numpy(), v0 + g.tri_e2.numpy()


def _rays(rng, n, lo=-1.5, hi=1.5):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, np.full(n, 1e-4, np.float32), np.full(n, 3.4e38, np.float32)


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _refs(pairs):
    return np.ascontiguousarray(pairs[:, 12:14]).view(np.int32)


@pytest.fixture(scope="module")
def mesh():
    v0, v1, v2 = _cornell_tris(12, 7)
    assert v0.shape[0] == 300
    packed, leaf = bvh.build_bvh_tables(v0, v1, v2)
    return v0, v1, v2, packed, leaf, bvh.pack_child_pairs(packed)


@pytest.mark.parametrize("nu, nv", [(12, 7), (20, 13)])
def test_pack_child_pairs_holds_the_skip_link_tree(nu, nv):
    v0, v1, v2 = _cornell_tris(nu, nv)
    packed, _ = bvh.build_bvh_tables(v0, v1, v2)
    pairs = bvh.pack_child_pairs(packed)
    links = np.ascontiguousarray(packed[:, 6:8]).view(np.int32)
    skip, first = links[:, 0], links[:, 1]
    n_leaves = (packed.shape[0] + 1) // 2
    assert pairs.shape == (n_leaves - 1, bvh.PAIR_COLS) and pairs.dtype == np.float32
    refs = _refs(pairs)
    seen_rows, seen_leaves = [], []
    todo = [(0, 0)]  # (pair row, its interior node)
    while todo:
        r, i = todo.pop()
        seen_rows.append(r)
        for side, child in enumerate((i + 1, skip[i + 1])):
            np.testing.assert_array_equal(_bits(pairs[r, 6 * side:6 * side + 6]),
                                          _bits(packed[child, 0:6]))
            ref = refs[r, side]
            if first[child] >= 0:
                assert ref == ~(first[child] // bvh.LEAF_SIZE)
                seen_leaves.append(~ref)
            else:
                assert ref >= 0
                todo.append((ref, child))
    assert sorted(seen_rows) == list(range(pairs.shape[0]))
    assert sorted(seen_leaves) == list(range(n_leaves))
    # breadth first: every row's interior children come after it, and the
    # tree's levels are the builder's median split's
    assert all(ref > r for r in range(pairs.shape[0]) for ref in refs[r] if ref >= 0)
    assert bvh.pairs_depth(pairs) == int(np.ceil(np.log2(n_leaves))) + 1


def test_one_leaf_tree(mesh):
    v0, v1, v2 = (x[:3] for x in mesh[:3])
    packed, leaf = bvh.build_bvh_tables(v0, v1, v2)
    assert packed.shape[0] == 1
    pairs = bvh.pack_child_pairs(packed)
    assert pairs.shape == (1, bvh.PAIR_COLS)
    np.testing.assert_array_equal(_bits(pairs[0, 0:6]), _bits(packed[0, 0:6]))
    assert np.isnan(pairs[0, 6:12]).all() and list(_refs(pairs)[0]) == [~0, ~0]
    assert bvh.pairs_depth(pairs) == 2
    rng = np.random.default_rng(8)
    o, _, mint, cut = _rays(rng, 2000)
    # aimed at the three triangles, so that many rays hit one
    d = (v0[rng.integers(0, 3, 2000)] + 0.1 * rng.normal(size=(2000, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = tuple(map(T, (o, d, mint, cut)))
    got = bvh.traverse_pairs_ref(T(pairs), T(leaf), *rays, with_visits=True)
    ref = isect.mt_sweep_ref(*rays, T(v0), T(v1 - v0), T(v2 - v0))
    assert 0.2 < float((ref[0] >= 0).float().mean()) < 0.95
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    # the root's row, then the leaf where its box is hit
    assert bool((got[4][0] == 1).all()) and bool((got[4][1] <= 1).all())


def _jax_walk(v0, v1, v2, o, d, mint, cut, any_hit):
    jb = jbvh.build_bvh(v0, v1, v2)
    j_t, j_id, _, _, j_found = jax.jit(jbvh._traverse_walk, static_argnums=6)(
        jb, jnp.asarray(v0), jnp.asarray(v1 - v0), jnp.asarray(v2 - v0),
        JRay(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint), jnp.asarray(cut)),
        jnp.asarray(cut), any_hit)
    return np.asarray(j_t), np.asarray(j_id), np.asarray(j_found)


def test_closest_hit_matches_jax_walk(mesh):
    v0, v1, v2, packed, leaf, pairs = mesh
    rng = np.random.default_rng(9)
    o, d, mint, cut = _rays(rng, 3000)
    j_t, j_id, j_found = _jax_walk(v0, v1, v2, o, d, mint, cut, False)
    ids, t, _, _ = bvh.traverse_pairs_ref(T(pairs), T(leaf), T(o), T(d), T(mint), T(cut))
    ids, t = ids.numpy(), t.numpy()
    assert 0.2 < j_found.mean() < 0.95
    np.testing.assert_array_equal(ids >= 0, j_found)
    np.testing.assert_allclose(t, j_t, rtol=1e-6)
    # rays whose winning t another triangle's hit equals bit for bit
    ht, _, _, h = bvh.mt_lanes(T(o)[:, None], T(d)[:, None], T(v0)[None], T(v1 - v0)[None],
                               T(v2 - v0)[None])
    h = (h & (ht >= T(mint)[:, None]) & (ht < T(cut)[:, None])).numpy()
    at_best = h & (ht.numpy() == t[:, None])
    tied = at_best.sum(axis=1) >= 2
    np.testing.assert_array_equal(ids[j_found & ~tied], np.asarray(j_id)[j_found & ~tied])
    np.testing.assert_array_equal(ids[tied], at_best[tied].argmax(axis=1))


def test_any_hit_masks_match_jax_walk(mesh):
    v0, v1, v2, packed, leaf, pairs = mesh
    rng = np.random.default_rng(10)
    o, d, mint, _ = _rays(rng, 3000)
    cut = rng.uniform(0.2, 2.0, 3000).astype(np.float32)  # shadow segments
    _, _, j_found = _jax_walk(v0, v1, v2, o, d, mint, cut, True)
    ids, t, _, _ = bvh.traverse_pairs_ref(T(pairs), T(leaf), T(o), T(d), T(mint), T(cut),
                                          any_hit=True)
    assert 0.2 < j_found.mean() < 0.95
    np.testing.assert_array_equal(ids.numpy() >= 0, j_found)
    hit = ids.numpy() >= 0
    assert (t.numpy()[hit] < cut[hit]).all() and (t.numpy()[hit] >= mint[hit]).all()


@pytest.mark.parametrize("nu, nv", [(12, 7), (20, 13)])
def test_closest_hit_ids_equal_the_sweep(nu, nv):
    v0, v1, v2 = _cornell_tris(nu, nv)
    packed, leaf = bvh.build_bvh_tables(v0, v1, v2)
    rng = np.random.default_rng(11)
    rays = tuple(map(T, _rays(rng, 3000)))
    got = bvh.traverse_pairs_ref(T(bvh.pack_child_pairs(packed)), T(leaf), *rays)
    ref = isect.mt_sweep_ref(*rays, T(v0), T(v1 - v0), T(v2 - v0))
    assert 0.2 < float((ref[0] >= 0).float().mean()) < 0.95
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_built_ties_resolve_to_the_lower_id():
    """Every triangle of a soup appears twice, under ids k and k + 500; with
    each leaf's slots reversed the higher id of a pair is met first, and the
    walk still returns the lower, the sweep's lowest-index minimum."""
    rng = np.random.default_rng(12)
    v0 = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.2, (500, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.2, (500, 3)).astype(np.float32)
    v0, e1, e2 = (np.concatenate([x, x]) for x in (v0, e1, e2))
    packed, leaf = bvh.build_bvh_tables_from_edges(v0, e1, e2)
    leaf = np.ascontiguousarray(leaf.reshape(-1, bvh.LEAF_SIZE, 10)[:, ::-1].reshape(-1, 40))
    rays = tuple(map(T, _rays(rng, 3000)))
    got = bvh.traverse_pairs_ref(T(bvh.pack_child_pairs(packed)), T(leaf), *rays)
    ref = isect.mt_sweep_ref(*rays, T(v0), T(e1), T(e2))
    assert float((ref[0] >= 0).float().mean()) > 0.2 and bool((ref[0] < 500).all())
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    # the skip-link walk takes the first it meets, here the higher id
    first_met = bvh.traverse_walk_ref(T(packed), T(leaf), *rays)
    assert bool((first_met[0] >= 500).any())


def _left_spine(levels):
    """A skip-link tree whose interior nodes all lie on the left spine (in
    preorder 0 .. levels - 2), every one of them with a leaf as its right
    child, one triangle per leaf, all boxes the same: a walk that enters the
    left child first pushes one entry per level."""
    m = levels  # leaves
    n = 2 * m - 1
    skip = np.empty(n, np.int32)
    first = np.full(n, -1, np.int32)
    skip[0] = n
    for k in range(1, m - 1):
        skip[k] = 2 * m - 1 - k  # the right child of node k - 1
    skip[m - 1] = m  # the deepest left leaf's sibling
    for j in range(m - 1):  # node 2m - 2 - j is the right child of node j
        skip[2 * m - 2 - j] = n if j == 0 else 2 * m - 1 - j
    leaf_nodes = [m - 1] + [2 * m - 2 - j for j in range(m - 2, -1, -1)]
    first[leaf_nodes] = np.arange(m, dtype=np.int32) * bvh.LEAF_SIZE
    rng = np.random.default_rng(13)
    v0 = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.3, (m, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.3, (m, 3)).astype(np.float32)
    box = np.tile(np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32), (n, 1))
    packed = bvh._pack_nodes(box[:, 0:3], box[:, 3:6], skip, first)
    prim = np.full(m * bvh.LEAF_SIZE, -1, np.int32)
    prim[::bvh.LEAF_SIZE] = np.arange(m)
    return packed, bvh._pack_tri_leaves(prim, v0, e1, e2, bvh.LEAF_SIZE), (v0, e1, e2)


def test_a_tree_deeper_than_the_stack_is_refused():
    rng = np.random.default_rng(14)
    rays = tuple(map(T, _rays(rng, 256, -0.2, 0.2)))
    ok_packed, ok_leaf, tris = _left_spine(bvh.STACK_DEPTH)
    ok = Bvh(packed=T(ok_packed), leaf=T(ok_leaf), pairs=T(bvh.pack_child_pairs(ok_packed)))
    assert ok.depth == bvh.STACK_DEPTH
    # a valid skip-link tree: both walks give the sweep's hits
    ref = isect.mt_sweep_ref(*rays, *map(T, tris))
    assert float((ref[0] >= 0).float().mean()) > 0.2
    assert torch.equal(bvh.traverse_walk_ref(ok.packed, ok.leaf, *rays, lowest_id=True)[0], ref[0])
    got = isect.isect_bvh(ok, *rays, with_visits=True)
    assert torch.equal(got[0], ref[0]) and int(got[4][0].max()) == bvh.STACK_DEPTH - 1
    deep_packed, deep_leaf, _ = _left_spine(bvh.STACK_DEPTH + 2)
    deep = Bvh(packed=T(deep_packed), leaf=T(deep_leaf),
               pairs=T(bvh.pack_child_pairs(deep_packed)))
    assert deep.depth == bvh.STACK_DEPTH + 2
    with pytest.raises(ValueError, match="deeper than the pair walk's stack"):
        isect.isect_bvh(deep, *rays)
    # the plain version refuses the overflow itself
    with pytest.raises(ValueError, match="deeper than the pair walk's stack"):
        bvh.traverse_pairs_ref(deep.pairs, deep.leaf, *rays)


@pytest.mark.parametrize("any_hit", [False, True])
def test_isect_bvh_on_cpu_runs_the_plain_version(mesh, any_hit):
    _, _, _, packed, leaf, pairs = mesh
    rng = np.random.default_rng(15)
    o, d, mint, cut = _rays(rng, 1000)
    if any_hit:
        cut = rng.uniform(0.2, 2.0, 1000).astype(np.float32)
    rays = tuple(map(T, (o, d, mint, cut)))
    tables = Bvh(packed=T(packed), leaf=T(leaf), pairs=T(bvh.pack_child_pairs(packed)))
    before = dict(isect.LAUNCHES)
    got = isect.isect_bvh(tables, *rays, any_hit=any_hit, with_visits=True)
    ref = bvh.traverse_pairs_ref(T(pairs), T(leaf), *rays, any_hit=any_hit, with_visits=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert isect.LAUNCHES == before


def test_scene_builders_carry_the_pair_table():
    from optix_renderer_tpu.scene.presets import make_tessellated_cornell as jax_tess

    scene, _, _ = presets.make_tessellated_cornell(24, 16, 1, nu=12, nv=7, device="cpu")
    b = scene.geometry.bvh
    np.testing.assert_array_equal(_bits(b.pairs.numpy()),
                                  _bits(bvh.pack_child_pairs(b.packed.numpy())))
    assert b.depth == bvh.pairs_depth(b.pairs.numpy()) and b.to("cpu").depth == b.depth
    jscene, _, _ = jax_tess(24, 16, 1, nu=12, nv=7)
    carried = scene_from_numpy(jax.tree.map(np.asarray, jscene)).geometry.bvh
    for name in ("packed", "leaf", "pairs"):
        np.testing.assert_array_equal(_bits(getattr(carried, name).numpy()),
                                      _bits(getattr(b, name).numpy()))
    assert carried.depth == b.depth
