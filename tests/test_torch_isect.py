"""The port's LBVH build and its plain intersection versions against the JAX
package, on the same inputs made from a numpy seed.

* `build_lbvh_numpy` + packing equal the JAX arrays bit for bit (the skip and
  first links are int32 bits in float32 columns, compared as int32);
* `traverse_walk_ref` against `bvh._traverse_walk`, closest and any hit: ids
  equal, t within 1e-6 relative;
* `mt_sweep_ref` against `_mt_jnp` (ids equal) and against
  `mxu_raw(interpret=True)` (ids equal on ≥ 99.9 % of the rays: the matmul
  form rounds t differently, which can reorder near-ties);
* on CPU tensors the kernel wrappers run their plain versions (the LBVH
  kernel's is `traverse_pairs_ref`, tested in test_torch_isect_pairs.py) and
  count no launch.

XLA on the CPU contracts multiply-adds into FMAs and torch does not, so
values agree to rounding, not bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.core.math import Ray as JRay
from optix_renderer_tpu.ops import bvh as jbvh
from optix_renderer_tpu.ops.pallas.mt_kernel import _mt_jnp
from optix_renderer_tpu.ops.pallas.mxu_intersect import build_tri_coeffs, mxu_raw
from optix_renderer_tpu_torch.ops import bvh
from optix_renderer_tpu_torch.ops.cuda import isect
from optix_renderer_tpu_torch.scene import presets
from optix_renderer_tpu_torch.scene.data import Bvh


def _soup(rng, n):
    v0 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    return v0, (v0 + rng.normal(0, 0.2, (n, 3))).astype(np.float32), \
        (v0 + rng.normal(0, 0.2, (n, 3))).astype(np.float32)


def _mesh_tris():
    """The tessellated Cornell box at nu=12, nv=7: 300 triangles."""
    s, _, _ = presets.make_tessellated_cornell(24, 16, 1, nu=12, nv=7, device="cpu")
    g = s.geometry
    v0 = g.tri_v0.numpy()
    return v0, v0 + g.tri_e1.numpy(), v0 + g.tri_e2.numpy()


def _rays(rng, n, lo=-1.5, hi=1.5):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, np.full(n, 1e-4, np.float32), np.full(n, 3.4e38, np.float32)


@pytest.fixture(scope="module")
def mesh():
    v0, v1, v2 = _mesh_tris()
    assert v0.shape[0] == 300
    packed, leaf = bvh.build_bvh_tables(v0, v1, v2)
    return v0, v1, v2, packed, leaf


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("kind", ["mesh300", "soup1000"])
def test_lbvh_build_matches_jax(kind):
    v0, v1, v2 = _mesh_tris() if kind == "mesh300" else _soup(np.random.default_rng(1), 1000)
    got = bvh.build_lbvh_numpy(v0, v1, v2)
    ref = jbvh.build_lbvh_numpy(v0, v1, v2)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    packed, leaf = bvh.build_bvh_tables(v0, v1, v2)
    np.testing.assert_array_equal(_bits(packed), _bits(jbvh._pack_nodes(*ref[:4])))
    np.testing.assert_array_equal(
        _bits(leaf), _bits(jbvh._pack_tri_leaves(ref[4], v0, v1 - v0, v2 - v0, jbvh.LEAF_SIZE)))
    # the JAX build (native or numpy) is what scene_from_numpy carries across
    jb = jbvh.build_bvh(v0, v1, v2)
    np.testing.assert_array_equal(_bits(packed), _bits(np.asarray(jb.packed)))
    np.testing.assert_array_equal(_bits(leaf), _bits(np.asarray(jb.leaf)))


@pytest.mark.parametrize("any_hit", [False, True])
def test_traverse_walk_ref_matches_jax(mesh, any_hit):
    v0, v1, v2, packed, leaf = mesh
    rng = np.random.default_rng(2)
    o, d, mint, cut = _rays(rng, 3000)
    if any_hit:  # finite shadow segments: about half of them blocked
        cut = rng.uniform(0.2, 2.0, 3000).astype(np.float32)
    jb = jbvh.build_bvh(v0, v1, v2)
    e1, e2 = v1 - v0, v2 - v0
    j_t, j_id, _, _, j_found = jax.jit(jbvh._traverse_walk, static_argnums=6)(
        jb, jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2),
        JRay(jnp.asarray(o), jnp.asarray(d), jnp.asarray(mint), jnp.asarray(cut)),
        jnp.asarray(cut), any_hit)
    T = torch.from_numpy
    ids, t, u, v = bvh.traverse_walk_ref(T(packed), T(leaf), T(o), T(d), T(mint), T(cut),
                                         any_hit)
    j_found = np.asarray(j_found)
    assert 0.2 < j_found.mean() < 0.95
    np.testing.assert_array_equal(ids.numpy() >= 0, j_found)
    np.testing.assert_array_equal(ids.numpy()[j_found], np.asarray(j_id)[j_found])
    np.testing.assert_allclose(t.numpy(), np.asarray(j_t), rtol=1e-6)
    # the replay recomputes the walk's own (t, u, v) from the triangle arrays
    hit = ids.numpy() >= 0
    k = ids.numpy()[hit]
    tr, ur, vr = bvh.replay_tri(T(o[hit]), T(d[hit]), T(v0[k]), T(e1[k]), T(e2[k]))
    np.testing.assert_array_equal(tr.numpy(), t.numpy()[hit])
    np.testing.assert_array_equal(ur.numpy(), u.numpy()[hit])
    np.testing.assert_array_equal(vr.numpy(), v.numpy()[hit])


def test_mt_sweep_ref_matches_mt_jnp():
    rng = np.random.default_rng(3)
    v0, v1, v2 = _soup(rng, 500)
    e1, e2 = v1 - v0, v2 - v0
    o, d, mint, cut = _rays(rng, 2048)
    j_t, _, _, j_idf = jax.jit(_mt_jnp)(*map(jnp.asarray, (o, d, mint, cut, v0, e1, e2)))
    T = torch.from_numpy
    ids, t, _, _ = isect.mt_sweep_ref(*map(T, (o, d, mint, cut, v0, e1, e2)))
    j_id = np.asarray(j_idf).astype(np.int32)
    assert 0.2 < (j_id >= 0).mean() < 0.95
    np.testing.assert_array_equal(ids.numpy(), j_id)
    # `_mt_jnp` takes t from the [N, T] sweep, whose dot products XLA fuses
    # into FMAs; near-parallel rays lose a few more bits there than in a walk
    np.testing.assert_allclose(t.numpy(), np.asarray(j_t), rtol=1e-5)


def test_mt_sweep_ref_matches_mxu_interpret():
    rng = np.random.default_rng(4)
    v0, v1, v2 = _soup(rng, 64)
    e1, e2 = v1 - v0, v2 - v0
    o, _, mint, cut = _rays(rng, 512)
    # aimed at the soup, so that most rays hit something
    d = rng.uniform(-0.8, 0.8, (512, 3)).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    coeffs = jnp.asarray(build_tri_coeffs(v0, e1, e2))
    _, _, _, j_idf = mxu_raw(*map(jnp.asarray, (o, d, mint, cut)), coeffs, interpret=True)
    T = torch.from_numpy
    ids, _, _, _ = isect.mt_sweep_ref(*map(T, (o, d, mint, cut, v0, e1, e2)))
    j_id = np.asarray(j_idf).astype(np.int32)
    assert 0.2 < (j_id >= 0).mean()
    assert (ids.numpy() == j_id).mean() >= 0.999


def test_wrappers_run_the_plain_versions_on_cpu(mesh):
    v0, v1, v2, packed, leaf = mesh
    rng = np.random.default_rng(5)
    T = torch.from_numpy
    rays = tuple(map(T, _rays(rng, 512)))
    tri = T(np.concatenate([v0, v1 - v0, v2 - v0], axis=1))
    tables = Bvh(packed=T(packed), leaf=T(leaf), pairs=T(bvh.pack_child_pairs(packed)))
    before = dict(isect.LAUNCHES)
    got = isect.isect_bvh(tables, *rays, with_visits=True)
    ref = bvh.traverse_pairs_ref(tables.pairs, tables.leaf, *rays, with_visits=True)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    # every ray reads the root's pair row, which names at most two leaves,
    # and each further row at most two more; a ray that hits tested a leaf
    visits = got[4]
    assert visits.shape == (2, 512) and bool((visits[0] >= 1).all())
    assert bool((visits[1] <= 2 * visits[0]).all())
    assert bool((visits[1][got[0] >= 0] >= 1).all())
    # the brute sweep finds the LBVH walk's closest hits
    brute = isect.isect_brute(tri, *rays)
    assert torch.equal(brute[0], got[0]) and torch.equal(brute[1], got[1])
    assert isect.LAUNCHES == before
