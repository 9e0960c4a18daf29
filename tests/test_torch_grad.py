"""Gradients of the port (`parallel/shard.py`, `render_round`, the trackers'
score surrogates) against finite differences, analytic derivatives and
the JAX package, on the CPU.

The port against itself, as tests/test_grad.py holds the JAX package:

* FD against AD along a random direction per parameter on the
  brute-force Cornell box (32×24, depth 3, `path_mats`; `em_radiance` and
  `tex_value`, rtol 2e-2), on the 1,068-triangle tessellated box, whose
  intersections walk the LBVH (`nu=24, nv=12`), and on a homogeneous
  medium cube (`em_radiance` rtol 2e-2, σs rtol 5e-2);
* ratio tracking's mean derivative against the analytic d/dc e^(−c·L),
  and delta tracking's w_score exactly 1 with the escape probability's
  analytic derivative (the JAX tests' tolerances, 0.15 and 0.2);
* the pair walk's detach-and-replay gradients against a differentiable
  brute-force sweep and the JAX `_mt_jnp` sweep (rtol 1e-4, atol 1e-5).

The port against JAX, on one scene and one parameter set carried across
with `scene_from_numpy` / `params_from_numpy` (each JAX gradient computed
once, in a module fixture):

* the Cornell loss's `em_radiance`, `tex_value`, `bsdf_kd` (and
  `bsdf_alpha`) gradients, rtol 1e-3, atol 1e-6;
* `train_step` against `sharded_train_step` on a one-device mesh at 16×12,
  depth 2: loss rel 1e-4, gradients rtol 1e-3 (atol 1e-6);
* the homogeneous cube's σs directional derivative (JAX by `jax.jvp`),
  rel 1e-3;
* the trackers' summed σs gradients on 8,192 rays through a constant
  grid (the rays of tests/test_grad.py:178, 225), rel 1e-4.
"""

import dataclasses
import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

import test_heterog as th
from optix_renderer_tpu.ops import volume_grid as jvg
from optix_renderer_tpu.ops.pallas.mt_kernel import _mt_jnp
from optix_renderer_tpu.parallel.shard import apply_params as japply_params
from optix_renderer_tpu.parallel.shard import make_mesh, sharded_train_step
from optix_renderer_tpu.parallel.shard import trainable_params as jtrainable_params
from optix_renderer_tpu.render import sampler as jsmp
from optix_renderer_tpu.render.render import render_round as jrender_round
from optix_renderer_tpu.scene import build as jbuild
from optix_renderer_tpu.scene.presets import make_cornell_box as jmake_cornell_box
from optix_renderer_tpu_torch.core.math import Ray
from optix_renderer_tpu_torch.ops import bvh as bvh_ops
from optix_renderer_tpu_torch.ops import volume_grid as vg
from optix_renderer_tpu_torch.ops.cuda import isect
from optix_renderer_tpu_torch.ops.intersect import PRIM_TRI, intersect
from optix_renderer_tpu_torch.parallel.shard import apply_params, train_step, trainable_params
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.render import film
from optix_renderer_tpu_torch.render.render import render_round, render_round_accumulate
from optix_renderer_tpu_torch.scene import build
from optix_renderer_tpu_torch.scene.data import (
    Bvh,
    Geometry,
    params_from_numpy,
    params_to_numpy,
    scene_from_numpy,
)
from optix_renderer_tpu_torch.scene.presets import make_cornell_box, make_tessellated_cornell

# tests/test_grad.py:113-136: a homogeneous medium cube lit by a point light
HOMOG_XML = """
<scene>
  <integrator type="path_vol_mis"/>
  <sampler type="independent"><integer name="sampleCount" value="1"/></sampler>
  <camera type="perspective">
    <float name="fov" value="35"/>
    <transform name="toWorld"><lookat target="0,0,0" origin="0,-2.5,0" up="0,0,1"/></transform>
    <integer name="width" value="24"/><integer name="height" value="24"/>
  </camera>
  <shape type="obj">
    <string name="filename" value="cube.obj"/>
    <medium type="homog">
      <color name="sigma_a" value="0.4,0.5,0.6"/>
      <color name="sigma_s" value="1.2,1.0,0.8"/>
    </medium>
  </shape>
  <emitter type="point">
    <point name="position" value="0,-2,2"/>
    <color name="power" value="400,400,400"/>
  </emitter>
</scene>
"""
N_TRACK = 8192


def _image_loss(scene, config):
    """mean(composite²) of one `render_round` as a function of the parameters."""
    pix = torch.arange(config.width * config.height)

    def loss(params):
        img = render_round(apply_params(scene, params), config, pix, 0)
        return torch.mean(img[0, ..., :3] ** 2)

    return loss


def _leaves(tensors):
    return {k: v.detach().clone().requires_grad_(True) for k, v in tensors.items()}


def _grads(loss_value, params):
    gs = torch.autograd.grad(loss_value, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), gs)}


def _fd_vs_ad(loss, params, key, h):
    """(AD, central FD) directional derivative along a random direction of
    `params[key]` (the direction of tests/test_grad.py's `_check_directions`)."""
    rng = np.random.default_rng(zlib.crc32(key.encode()))
    d = torch.from_numpy(rng.standard_normal(tuple(params[key].shape)).astype(np.float32))
    ad = float((_grads(loss(params), params)[key] * d).sum())
    with torch.no_grad():
        plus = {k: v + h * d if k == key else v for k, v in params.items()}
        minus = {k: v - h * d if k == key else v for k, v in params.items()}
        fd = (float(loss(plus)) - float(loss(minus))) / (2.0 * h)
    return ad, fd


def _check_directions(scene, config, cases, rtol):
    loss = _image_loss(scene, config)
    params = _leaves(trainable_params(scene))
    for key, h in cases:
        ad, fd = _fd_vs_ad(loss, params, key, h)
        assert np.isfinite(ad) and np.isfinite(fd), (key, ad, fd)
        assert abs(ad) > 1e-8, f"{key}: AD gradient vanished ({ad})"
        assert ad == pytest.approx(fd, rel=rtol), (key, ad, fd)


@pytest.fixture(scope="module")
def homog(tmp_path_factory):
    """The homogeneous cube: its XML, the port's build and the JAX build."""
    tmp = tmp_path_factory.mktemp("homog")
    th._write_cube_obj(tmp / "cube.obj")
    (tmp / "scene.xml").write_text(HOMOG_XML)
    scene, config, _ = build.load_scene(tmp / "scene.xml", device="cpu")
    js, jc, _ = jbuild.load_scene(str(tmp / "scene.xml"))
    return (scene, dataclasses.replace(config, max_depth=3), js,
            dataclasses.replace(jc, max_depth=3))


def _sigma_s_loss(scene, config):
    pix = torch.arange(config.width * config.height)

    def loss(sigma_s):
        sc = dataclasses.replace(scene, media=dataclasses.replace(scene.media, sigma_s=sigma_s))
        return torch.mean(render_round(sc, config, pix, 0)[0, ..., :3] ** 2)

    return loss


def test_fd_cornell_brute_force_path():
    """12-triangle Cornell box (the brute-force sweep): emitter radiance and
    texture albedo gradients match central differences."""
    scene, config, _ = make_cornell_box(32, 24, 1, "path_mats", device="cpu")
    config = dataclasses.replace(config, max_depth=3)
    assert scene.geometry.tri_v0.shape[0] < bvh_ops.MIN_TRIS_FOR_BVH
    _check_directions(scene, config, [("em_radiance", 2e-2), ("tex_value", 2e-2)], rtol=2e-2)


def test_fd_bvh_scene():
    """≥ 257 triangles: intersections walk the LBVH's child pairs on
    detached inputs, the winner is replayed live, and the gradients match
    central differences."""
    scene, config, _ = make_tessellated_cornell(32, 24, 1, "path_mats", nu=24, nv=12, device="cpu")
    assert scene.geometry.tri_v0.shape[0] >= bvh_ops.MIN_TRIS_FOR_BVH
    assert scene.geometry.bvh is not None
    config = dataclasses.replace(config, max_depth=3)
    _check_directions(scene, config, [("em_radiance", 2e-2), ("tex_value", 2e-2)], rtol=2e-2)


def test_fd_homogeneous_medium(homog):
    """path_vol_mis through a homogeneous cube at depth 3 (no Russian
    roulette): the point light's radiance gradient and the σs gradient,
    which rides the free-path sample and the spectral weights, match
    central differences."""
    scene, config, _, _ = homog
    _check_directions(scene, config, [("em_radiance", 2e-1)], rtol=2e-2)
    loss = _sigma_s_loss(scene, config)
    s0 = scene.media.sigma_s.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(s0), s0)
    d = torch.from_numpy(np.random.default_rng(7).standard_normal(tuple(s0.shape))
                         .astype(np.float32))
    ad = float((g * d).sum())
    h = 1e-2
    with torch.no_grad():
        fd = (float(loss(s0 + h * d)) - float(loss(s0 - h * d))) / (2 * h)
    assert np.isfinite(ad) and abs(ad) > 1e-8
    assert ad == pytest.approx(fd, rel=5e-2), (ad, fd)


def _track_setup(tmp_path, sigma_a, sigma_s, seed):
    """A constant 8³ grid on the unit cube (tests/test_heterog.py), built by
    the JAX package and carried across, and 8,192 rays along +x through it,
    for both packages."""
    js, _, _ = th._heterog_scene(tmp_path, np.ones((8, 8, 8), np.float32), sigma_a, sigma_s)
    media = scene_from_numpy(jax.tree.map(np.asarray, js)).media
    n = N_TRACK
    rays = (torch.zeros(n, dtype=torch.int32), smp.make_sampler(torch.arange(n), 0, seed=seed),
            torch.tensor([[-2.0, 0.0, 0.0]]).expand(n, 3).contiguous(),
            torch.tensor([[1.0, 0.0, 0.0]]).expand(n, 3).contiguous(), torch.full((n,), 10.0))
    jrays = (jnp.zeros(n, jnp.int32),
             jsmp.make_sampler(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0), seed=seed),
             jnp.tile(jnp.array([[-2.0, 0.0, 0.0]]), (n, 1)),
             jnp.tile(jnp.array([[1.0, 0.0, 0.0]]), (n, 1)), jnp.full(n, 10.0))
    return media, rays, js.media, jrays


def _mean_ratio_T(media, rays, sigma_s):
    med, s, o, d, dist = rays
    _, tr = vg.ratio_track(dataclasses.replace(media, sigma_s=sigma_s), med, s, o, d, dist)
    return tr[:, 0].mean()


def _escape_prob(media, rays, sigma_s):
    med, s, o, d, t_max = rays
    _, t_e, w = vg.delta_track(dataclasses.replace(media, sigma_s=sigma_s), med, s, o, d, t_max)
    return torch.mean(w * torch.isinf(t_e).to(torch.float32))


def test_ratio_track_gradient_analytic(tmp_path):
    """On a constant grid the mean AD derivative of ratio tracking's T with
    respect to σ matches −L·e^(−c·L) with L from the measured T (the JAX
    test's self-consistent check); the achromatic max splits the gradient
    over its three tied channels, so the summed gradient is compared."""
    sigma_a = sigma_s = 0.75
    media, rays, _, _ = _track_setup(tmp_path, sigma_a, sigma_s, seed=3)
    sig = media.sigma_s.clone().requires_grad_(True)
    val = _mean_ratio_T(media, rays, sig)
    (grad,) = torch.autograd.grad(val, sig)
    c = sigma_a + sigma_s
    assert float(val.detach()) == pytest.approx(np.exp(-c), rel=0.12)
    l_eff = -np.log(float(val)) / c
    assert float(grad.sum()) == pytest.approx(-l_eff * float(val), rel=0.15)


def test_delta_track_score_weight_unit_value(tmp_path):
    """delta_track's w_score is exactly 1 in value, and the escape
    estimator mean(w·[escaped])'s AD derivative matches d/dc e^(−c)."""
    sigma_a = sigma_s = 1.0
    media, rays, _, _ = _track_setup(tmp_path, sigma_a, sigma_s, seed=11)
    med, s, o, d, t_max = rays
    _, _, w = vg.delta_track(media, med, s, o, d, t_max)
    assert torch.equal(w, torch.ones_like(w))
    sig = media.sigma_s.clone().requires_grad_(True)
    val = _escape_prob(media, rays, sig)
    (grad,) = torch.autograd.grad(val, sig)
    c = sigma_a + sigma_s
    assert float(val) == pytest.approx(np.exp(-c), rel=0.07)
    assert float(grad.sum()) == pytest.approx(-np.exp(-c), rel=0.2)


@pytest.mark.parametrize("kind", ["ratio", "delta"])
def test_tracker_gradients_match_jax(tmp_path, kind):
    """The same 8,192 rays through the JAX trackers and the port's: equal
    values and summed σs gradients to 1e-4 (K and the spans per lane equal
    JAX's, tests/test_torch_media.py)."""
    sigma, seed = (0.75, 3) if kind == "ratio" else (1.0, 11)
    media, rays, jmedia, jrays = _track_setup(tmp_path, sigma, sigma, seed)
    jmed, js, jo, jd, jdist = jrays

    def jfun(sig):
        m = jmedia._replace(sigma_s=sig)
        if kind == "ratio":
            return jnp.mean(jvg.ratio_track(m, jmed, js, jo, jd, jdist)[1][:, 0])
        _, t_e, w = jvg.delta_track(m, jmed, js, jo, jd, jdist)
        return jnp.mean(w * jnp.where(jnp.isinf(t_e), 1.0, 0.0))

    jval, jgrad = jax.value_and_grad(jfun)(jmedia.sigma_s)
    sig = media.sigma_s.clone().requires_grad_(True)
    val = (_mean_ratio_T if kind == "ratio" else _escape_prob)(media, rays, sig)
    (grad,) = torch.autograd.grad(val, sig)
    assert float(val) == pytest.approx(float(jval), rel=1e-4)
    assert float(grad.sum()) == pytest.approx(float(jnp.sum(jgrad)), rel=1e-4)


def _soup_and_rays():
    """tests/test_grad.py:266's 300-triangle soup and 64 rays."""
    rng = np.random.default_rng(5)
    n_tri = 300
    v0 = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (n_tri, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n_tri, 3)).astype(np.float32)
    n = 64
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 3.0
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 1.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return v0, e1, e2, o, dirs


def test_traverse_replay_matches_brute_gradients():
    """`intersect` on ≥ 257 triangles: the pair walk picks the winners on
    detached inputs and `replay_tri` recomputes t, u, v live; d(Σ t + u +
    v)/d(vertices) equals a differentiable brute-force sweep's and the JAX
    `_mt_jnp` sweep's."""
    v0, e1, e2, o, dirs = _soup_and_rays()
    n = o.shape[0]
    packed, leaf = bvh_ops.build_bvh_tables_from_edges(v0, e1, e2)
    bvh = Bvh(packed=torch.from_numpy(packed), leaf=torch.from_numpy(leaf),
              pairs=torch.from_numpy(bvh_ops.pack_child_pairs(packed)))
    ray = Ray(o=torch.from_numpy(o), d=torch.from_numpy(dirs), mint=torch.zeros(n),
              maxt=torch.full((n,), float("inf")))
    zeros = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt)

    def loss_walk(v0t, e1t, e2t):
        geom = Geometry(tri_v0=v0t, tri_e1=e1t, tri_e2=e2t, tri_n0=zeros(300, 3),
                        tri_n1=zeros(300, 3), tri_n2=zeros(300, 3), tri_uv0=zeros(300, 2),
                        tri_uv1=zeros(300, 2), tri_uv2=zeros(300, 2), tri_tang=zeros(300, 4),
                        tri_shape=zeros(300, dt=torch.int32), sph_center=zeros(0, 3),
                        sph_radius=zeros(0), sph_shape=zeros(0, dt=torch.int32), bvh=bvh)
        hit = intersect(geom, ray)
        found = hit.prim_kind == PRIM_TRI
        return torch.sum(torch.where(found, hit.t, 0.0) + torch.where(found, hit.u + hit.v, 0.0))

    def loss_brute(v0t, e1t, e2t):
        # every pair differentiable; argmin over the detached t picks the winner
        t, u, v, h = bvh_ops.mt_lanes(ray.o[:, None], ray.d[:, None], v0t[None], e1t[None],
                                      e2t[None])
        tm = torch.where(h & (t >= 0.0) & (t < bvh_ops.BIG), t, bvh_ops.BIG)
        j = torch.argmin(tm.detach(), dim=1)
        rows = torch.arange(n)
        found = tm[rows, j] < bvh_ops.BIG
        return torch.sum(torch.where(found, t[rows, j], 0.0)
                         + torch.where(found, u[rows, j] + v[rows, j], 0.0))

    args = [torch.from_numpy(x).requires_grad_(True) for x in (v0, e1, e2)]
    lw, lb = loss_walk(*args), loss_brute(*args)
    assert float(lw) == pytest.approx(float(lb), rel=1e-5)
    g_walk = torch.autograd.grad(lw, args)
    g_brute = torch.autograd.grad(lb, args)

    def jloss(v0j, e1j, e2j):
        t, u, v, idf = _mt_jnp(jnp.asarray(o), jnp.asarray(dirs), jnp.zeros(n),
                               jnp.full(n, 3.4e38), v0j, e1j, e2j)
        found = idf >= 0
        return jnp.sum(jnp.where(found, t, 0.0) + jnp.where(found, u + v, 0.0))

    g_jax = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    for gw, gb, gj in zip(g_walk, g_brute, g_jax):
        assert float(gw.abs().sum()) > 0
        np.testing.assert_allclose(gw.numpy(), gb.numpy(), rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(gw.numpy(), np.asarray(gj), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def cornell_jax():
    """The JAX Cornell loss (32×24, depth 3, path_mats) and its gradients."""
    js, jc, _ = jmake_cornell_box(width=32, height=24, spp=1, integrator="path_mats")
    jc = dataclasses.replace(jc, max_depth=3)
    pix = jnp.arange(32 * 24, dtype=jnp.int32)

    def loss(p):
        return jnp.mean(jrender_round(japply_params(js, p), jc, pix, jnp.int32(0))[0, ..., :3] ** 2)

    params = jtrainable_params(js)
    val, grads = jax.value_and_grad(loss)(params)
    return js, jc, jax.tree.map(np.asarray, params), float(val), jax.tree.map(np.asarray, grads)


def test_cornell_gradients_match_jax(cornell_jax):
    """One parameter set through both packages: the loss and every
    parameter's gradient agree (rtol 1e-3, atol 1e-6)."""
    js, jc, jparams, jval, jgrads = cornell_jax
    scene = scene_from_numpy(jax.tree.map(np.asarray, js))
    params = _leaves(params_from_numpy(jparams))
    val = _image_loss(scene, jc)(params)
    grads = params_to_numpy(_grads(val, params))
    assert float(val) == pytest.approx(jval, rel=1e-5)
    assert float(np.abs(jgrads["em_radiance"]).max()) > 0
    for key in ("em_radiance", "tex_value", "bsdf_kd", "bsdf_alpha"):
        np.testing.assert_allclose(grads[key], jgrads[key], rtol=1e-3, atol=1e-6, err_msg=key)


def test_train_step_matches_sharded_train_step():
    """`train_step` is the one-device `sharded_train_step`: the same loss
    (rel 1e-4) and gradients (rtol 1e-3) at 16×12, depth 2, path_mis, with
    a random target and sample 5."""
    js, jc, _ = jmake_cornell_box(width=16, height=12, spp=1, integrator="path_mis")
    jc = dataclasses.replace(jc, max_depth=2)
    target = np.random.default_rng(3).uniform(0, 1, (12, 16, 3)).astype(np.float32)
    jloss, jgrads = sharded_train_step(js, jc, make_mesh(n_devices=1), jnp.asarray(target),
                                       jnp.arange(16 * 12, dtype=jnp.int32), jnp.int32(5))
    scene = scene_from_numpy(jax.tree.map(np.asarray, js))
    loss, grads = train_step(scene, jc, torch.from_numpy(target), torch.arange(16 * 12), 5,
                             device="cpu")
    assert float(loss) == pytest.approx(float(jloss), rel=1e-4)
    grads = params_to_numpy(grads)
    assert set(grads) == {"tex_value", "bsdf_kd", "bsdf_alpha", "em_radiance"}
    for key, g in grads.items():
        assert np.isfinite(g).all(), key
        np.testing.assert_allclose(g, np.asarray(jgrads[key]), rtol=1e-3, atol=1e-6,
                                   err_msg=key)
    assert float(np.abs(grads["em_radiance"]).sum()) > 0


def test_homogeneous_sigma_s_derivative_matches_jax(homog):
    """The cube's σs directional derivative: the port's autograd against
    `jax.jvp` of the JAX `render_round` loss, rel 1e-3."""
    scene, config, js, jc = homog
    d = np.random.default_rng(7).standard_normal(tuple(scene.media.sigma_s.shape)).astype(
        np.float32)
    pix = jnp.arange(jc.width * jc.height, dtype=jnp.int32)

    def jloss(sig):
        img = jrender_round(js._replace(media=js.media._replace(sigma_s=sig)), jc, pix,
                            jnp.int32(0))
        return jnp.mean(img[0, ..., :3] ** 2)

    _, jdir = jax.jvp(jloss, (js.media.sigma_s,), (jnp.asarray(d),))
    s0 = scene.media.sigma_s.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(_sigma_s_loss(scene, config)(s0), s0)
    assert abs(float(jdir)) > 1e-8
    assert float((g * torch.from_numpy(d)).sum()) == pytest.approx(float(jdir), rel=1e-3)


def test_scene_to_and_detach_keep_and_cut_the_graph():
    """`scene.to(device)` is differentiable (a leaf on the CPU gets its
    gradient through the moved scene), `detach()` cuts every table, the
    kernel wrappers refuse tensors that require grad, and the parameter
    dicts round-trip through numpy."""
    scene, config, _ = make_cornell_box(8, 6, 1, "path_mis", device="cpu")
    config = dataclasses.replace(config, max_depth=2)
    em = scene.emitters.radiance.clone().requires_grad_(True)
    moved = dataclasses.replace(scene, emitters=dataclasses.replace(scene.emitters, radiance=em))
    moved = moved.to("cpu")
    img = render_round(moved, config, torch.arange(48), 0)
    (g,) = torch.autograd.grad(img[0, ..., :3].sum(), em)
    assert float(g.abs().sum()) > 0
    assert not moved.detach().emitters.radiance.requires_grad
    o = torch.zeros((4, 3), requires_grad=True)
    with pytest.raises(ValueError, match="detached"):
        isect.isect_brute(scene.geometry.tri_table, o, torch.ones(4, 3), torch.zeros(4),
                          torch.ones(4))
    numpy_params = params_to_numpy(trainable_params(scene))
    back = params_from_numpy(numpy_params)
    for k, v in trainable_params(scene).items():
        assert torch.equal(back[k], v) and numpy_params[k].dtype == np.float32


@pytest.mark.parametrize("rfilter", ["gaussian", "mitchell", "tent", "box"])
def test_render_round_is_accumulate_into_zeros(rfilter):
    """`render_round` on parameters that require grad gives the bits of
    `render_round_accumulate` into a zero film, and the splat's gradient
    is its adjoint: the splat is linear in `layers`, so
    <splat(layers), G> = <layers, ∂/∂layers <splat(layers), G>>."""
    scene, config, _ = make_cornell_box(12, 9, 1, "path_mis", device="cpu")
    config = dataclasses.replace(config, max_depth=2, rfilter=rfilter)
    pix = torch.arange(config.width * config.height)
    live = apply_params(scene, _leaves(trainable_params(scene)))
    img = render_round(live, config, pix, 3)
    assert img.requires_grad
    acc = torch.zeros((3, config.height, config.width, 4))
    with torch.no_grad():
        render_round_accumulate(acc, scene, config, pix, 3)
    assert torch.equal(img.detach(), acc)

    gen = torch.Generator().manual_seed(5)
    pos = torch.rand((200, 2), generator=gen) * torch.tensor([14.0, 11.0]) - 1.0
    layers = torch.randn((3, 200, 3), generator=gen, requires_grad=True)
    out = film.splat(12, 9, rfilter, pos, layers)
    big_g = torch.randn(out[..., :3].shape, generator=gen)
    inner = (out[..., :3] * big_g).sum()
    (g,) = torch.autograd.grad(inner, layers)
    assert float((layers.detach() * g).sum()) == pytest.approx(float(inner), rel=1e-5)
