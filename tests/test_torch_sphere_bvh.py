"""The port's spheres' LBVH (`ops/bvh.py: build_sphere_tables`,
`traverse_spheres_ref`, `replay_sphere`; `ops/intersect.py` from 65
spheres) against the JAX package on the CPU.

* the tables bit for bit against JAX `build_sphere_bvh` (1,000 spheres);
* the plain walk against JAX `_traverse_spheres_walk` on the soups of
  tests/test_bvh.py:50-156 (7, 64, 1,000 spheres, closest hit; 500, any
  hit): ids equal, t within rtol 1e-4 (the JAX package compiles the
  quadratic with FMA contraction; near-tangent hits amplify one ulp
  through b² − 4ac, as tests/test_bvh.py notes), any-hit masks equal;
* `intersect` from 65 spheres (the LBVH) against the quadratic over all
  spheres (64 and below): the same hits, t within rtol 1e-5 (the same
  arithmetic; the sweep and the walk meet the roots in another order only
  at exact ties);
* the replay's gradient against JAX `traverse_spheres` (rtol 1e-3) and
  against central differences (tests/test_grad.py:319, rel 2e-2);
* `scene_from_numpy` carries `sph_bvh` across, and the builder makes it
  from 65 spheres;
* an 80-sphere scene (`scene/presets.py: sphere_cornell_xml`) rendered on
  the CPU against the JAX scan path by the median statistic (< 1e-3,
  means within 10 %, tests/test_mega.py:203-211).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.core.math import Ray as JRay
from optix_renderer_tpu.ops import bvh as jbvh
from optix_renderer_tpu.render.render import render as jrender
from optix_renderer_tpu.scene import build as jbuild
from optix_renderer_tpu_torch.core.math import Ray
from optix_renderer_tpu_torch.ops import bvh
from optix_renderer_tpu_torch.ops import intersect as isect_ops
from optix_renderer_tpu_torch.ops.cuda import isect
from optix_renderer_tpu_torch.render.render import render
from optix_renderer_tpu_torch.scene import build
from optix_renderer_tpu_torch.scene.data import Bvh, Geometry, scene_from_numpy
from optix_renderer_tpu_torch.scene.presets import sphere_cornell_xml

T = torch.from_numpy


def _soup(n_sph: int, seed: int):
    """tests/test_bvh.py:50-55's sphere soup."""
    rng = np.random.default_rng(seed)
    center = rng.uniform(-3.0, 3.0, (n_sph, 3)).astype(np.float32)
    radius = rng.uniform(0.05, 0.4, n_sph).astype(np.float32)
    return center, radius


def _rays(n_rays: int, seed: int, maxt: float = 3.4e38):
    """tests/test_bvh.py:76-87's rays (cutoff 3.4e38 for an infinite maxt)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4.0, 4.0, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o, d, np.full(n_rays, 1e-4, np.float32), np.full(n_rays, maxt, np.float32))


def _tree(center, radius) -> Bvh:
    packed, leaf = bvh.build_sphere_tables(center, radius)
    return Bvh(packed=T(packed), leaf=T(leaf), pairs=T(bvh.pack_child_pairs(packed)))


def _geometry(center, radius, tree=None) -> Geometry:
    """A geometry of spheres only; center / radius numpy or tensors."""
    center, radius = torch.as_tensor(center), torch.as_tensor(radius)
    z3, z2 = torch.zeros((0, 3)), torch.zeros((0, 2))
    return Geometry(tri_v0=z3, tri_e1=z3, tri_e2=z3, tri_n0=z3, tri_n1=z3, tri_n2=z3,
                    tri_uv0=z2, tri_uv1=z2, tri_uv2=z2, tri_tang=torch.zeros((0, 4)),
                    tri_shape=torch.zeros(0, dtype=torch.int32), sph_center=center,
                    sph_radius=radius,
                    sph_shape=torch.zeros(len(radius), dtype=torch.int32), sph_bvh=tree)


def test_sphere_tables_bit_equal_jax():
    center, radius = _soup(1000, seed=13)
    jt = jbvh.build_sphere_bvh(center, radius)
    packed, leaf = bvh.build_sphere_tables(center, radius)
    assert leaf.shape == (250, 20)
    np.testing.assert_array_equal(np.asarray(jt.packed).view(np.uint32), packed.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(jt.leaf).view(np.uint32), leaf.view(np.uint32))


@pytest.mark.parametrize("n_sph,seed,ray_seed,maxt,any_hit", [
    (7, 13, 5, 3.4e38, False), (64, 13, 5, 3.4e38, False), (1000, 13, 5, 3.4e38, False),
    (500, 17, 9, 4.0, True), (1000, 13, 5, 3.4e38, True)])
def test_walk_matches_jax(n_sph, seed, ray_seed, maxt, any_hit):
    center, radius = _soup(n_sph, seed)
    o, d, mint, cut = _rays(512, ray_seed, maxt)
    jt = jbvh.build_sphere_bvh(center, radius)
    jray = JRay(o=jnp.asarray(o), d=jnp.asarray(d), mint=jnp.asarray(mint), maxt=jnp.asarray(cut))
    jt_, jid, jfound = jbvh._traverse_spheres_walk(jt, jnp.asarray(center), jnp.asarray(radius),
                                                   jray, jnp.asarray(cut), any_hit)
    jid = np.where(np.asarray(jfound), np.asarray(jid), -1)
    tree = _tree(center, radius)
    ids, t = isect.isect_spheres(tree, T(o), T(d), T(mint), T(cut), any_hit=any_hit)
    ids, t = ids.numpy(), t.numpy()
    hit = jid >= 0
    assert hit.any()
    if any_hit:
        np.testing.assert_array_equal(ids >= 0, hit)
    else:
        np.testing.assert_array_equal(ids, jid)
    np.testing.assert_allclose(t[hit], np.asarray(jt_)[hit], rtol=1e-4)
    np.testing.assert_array_equal(t[~hit], cut[~hit])


@pytest.mark.parametrize("any_hit", [False, True])
def test_intersect_through_the_lbvh_matches_the_sweep(any_hit):
    """From 65 spheres `intersect` no longer raises: the LBVH's hits are the
    quadratic's over all spheres (the path below 65)."""
    center, radius = _soup(300, seed=21)
    o, d, mint, cut = _rays(1024, seed=22, maxt=5.0 if any_hit else 3.4e38)
    ray = Ray(o=T(o), d=T(d), mint=T(mint), maxt=T(cut))
    got = isect_ops.intersect(_geometry(center, radius, _tree(center, radius)), ray, any_hit)
    n = len(radius)
    # the sweep over all spheres, as intersect runs it for 64 or fewer
    tn, tf, ok = isect_ops._ray_spheres(ray.o, ray.d, T(center), T(radius))
    lo, hi = ray.mint[:, None], ray.maxt[:, None]
    cand = torch.where(ok & (tn >= lo) & (tn < hi), tn,
                       torch.where(ok & (tf >= lo) & (tf < hi), tf, bvh.BIG))
    ref_t, ref_id = cand.min(dim=1)
    ref_hit = ref_t < bvh.BIG
    hit = got.prim_kind == isect_ops.PRIM_SPHERE
    assert int(ref_hit.sum()) > 100 and n >= bvh.MIN_SPHS_FOR_BVH
    assert torch.equal(hit, ref_hit)
    if not any_hit:
        assert torch.equal(got.prim_id[hit], ref_id[hit].to(torch.int32))
        np.testing.assert_allclose(got.t[hit].numpy(), ref_t[hit].numpy(), rtol=1e-5)


def test_replay_gradient_matches_jax_and_finite_differences():
    """tests/test_grad.py:319's configuration: d(sum of t)/d(center,
    radius) along a random direction, AD against JAX (rtol 1e-3) and
    against central differences at h 1e-3 (rel 2e-2)."""
    rng = np.random.default_rng(9)
    n_sph, n = 80, 32
    centers = rng.uniform(-2, 2, (n_sph, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.4, n_sph).astype(np.float32)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 5.0
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 0.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    d_c = rng.standard_normal(centers.shape).astype(np.float32)
    d_r = rng.standard_normal(radii.shape).astype(np.float32)
    tree = _tree(centers, radii)
    ray = Ray(o=T(o), d=T(dirs), mint=torch.zeros(n), maxt=torch.full((n,), float("inf")))

    def loss(c, r):
        hit = isect_ops.intersect(_geometry(c, r, tree), ray)
        return torch.where(hit.prim_kind == isect_ops.PRIM_SPHERE, hit.t, 0.0).sum()

    c0 = T(centers).requires_grad_(True)
    r0 = T(radii).requires_grad_(True)
    gc, gr = torch.autograd.grad(loss(c0, r0), (c0, r0))
    ad = float((gc * T(d_c)).sum() + (gr * T(d_r)).sum())
    h = 1e-3
    with torch.no_grad():
        fd = (float(loss(T(centers + h * d_c), T(radii + h * d_r)))
              - float(loss(T(centers - h * d_c), T(radii - h * d_r)))) / (2 * h)
    assert np.isfinite(ad) and abs(ad) > 1e-6
    assert ad == pytest.approx(fd, rel=2e-2)

    jt = jbvh.build_sphere_bvh(centers, radii)
    jray = JRay(o=jnp.asarray(o), d=jnp.asarray(dirs), mint=jnp.zeros(n),
                maxt=jnp.full(n, jnp.inf))

    def jloss(c, r):
        t, _, found = jbvh.traverse_spheres(jt, c, r, jray, jnp.full(n, 3.4e38))
        return jnp.sum(jnp.where(found, t, 0.0))

    jgc, jgr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(centers), jnp.asarray(radii))
    np.testing.assert_allclose(gc.numpy(), np.asarray(jgc), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(gr.numpy(), np.asarray(jgr), rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module")
def sphere_scene(tmp_path_factory):
    xml = sphere_cornell_xml(tmp_path_factory.mktemp("sph"), 24, 16, 2, "path_mis")
    js, jc, _ = jbuild.load_scene(xml)
    ts, tc, _ = build.load_scene(xml, device="cpu")
    return (js, dataclasses.replace(jc, max_depth=3), ts, dataclasses.replace(tc, max_depth=3))


def test_builder_and_scene_from_numpy_carry_the_spheres_lbvh(sphere_scene):
    js, _, ts, _ = sphere_scene
    g = ts.geometry
    assert g.sph_center.shape[0] == 80 and g.bvh is None
    carried = scene_from_numpy(jax.tree.map(np.asarray, js)).geometry
    for name in ("packed", "leaf", "pairs"):
        a, b = getattr(g.sph_bvh, name), getattr(carried.sph_bvh, name)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    assert g.sph_bvh.depth == carried.sph_bvh.depth
    np.testing.assert_array_equal(carried.sph_bvh.leaf.numpy(), np.asarray(js.geometry.sph_bvh.leaf))
    # 64 spheres: no tree, on either side
    small = build.load_scene(sphere_cornell_xml(
        __import__("tempfile").mkdtemp(), 8, 8, 1, nx=8, nz=8), device="cpu")[0]
    assert small.geometry.sph_center.shape[0] == 64 and small.geometry.sph_bvh is None


def test_sphere_scene_matches_jax(sphere_scene):
    js, jc, ts, tc = sphere_scene
    ref = np.asarray(jrender(js, jc, sample_count=2, mega=False, wavefront=False)["composite"])
    got = render(ts, tc, sample_count=2, device="cpu")
    assert got["spp_done"] == 2
    rel = np.abs(ref - got["composite"]) / (np.abs(ref) + 1e-3)
    assert np.median(rel) < 1e-3, np.median(rel)
    assert np.mean(got["composite"]) == pytest.approx(np.mean(ref), rel=0.1)
