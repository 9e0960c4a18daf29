"""Photon mapping in the port (`ops/photon.py`, `integrators/pmap.py`,
`render.preprocess`) against the JAX package, on the CPU.

* `_hash_cells` bit for bit on negative, zero and large cells, and
  `make_photon_map` bit for bit (both are integer / numpy code);
* `estimate_radiance` on a JAX map carried across by `scene_from_numpy`, in
  the setting of tests/test_photon.py:44-86, to rtol 1e-5;
* `sample_photon` per lane to 1e-5 for area (mesh and sphere), point,
  constant and image envmap and volume (ball and box) emitters;
* `trace_photons` slot by slot at 4,096 photons, depth 5: the valid masks
  equal on all but 1e-3 of the slots, positions within 1e-4 where both are
  valid. The JAX scan runs op by op (`jax.disable_jit`): compiled, XLA
  contracts multiply-adds across ops, and after a few bounces positions
  move by more than 1e-4;
* `preprocess` keeps a carried-across map and builds one otherwise, and
  `render()` and `render_adaptive` run it once per call;
* the photon-mapper film at 24×16 with the JAX map carried across meets
  tests/test_mega.py:203-211's median statistic, and at 48×48 (the
  configuration of tests/test_photon.py:88-99), each package building its
  own map, the film means agree within 5 %.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.core.math import make_frame as jmake_frame
from optix_renderer_tpu.integrators.common import ShadingCtx as JCtx
from optix_renderer_tpu.ops import photon as jph
from optix_renderer_tpu.ops.intersect import Interaction as JInteraction
from optix_renderer_tpu.render.render import render as jrender
from optix_renderer_tpu.scene.build import load_scene as jload_scene
from optix_renderer_tpu.scene.presets import make_cornell_box as jmake_cornell_box
from optix_renderer_tpu_torch.core.math import make_frame
from optix_renderer_tpu_torch.integrators import get_integrator
from optix_renderer_tpu_torch.integrators.common import ShadingCtx
from optix_renderer_tpu_torch.integrators.pmap import li_photonmapper
from optix_renderer_tpu_torch.ops import photon as ph
from optix_renderer_tpu_torch.ops.intersect import Interaction
from optix_renderer_tpu_torch.render.render import preprocess, render
from optix_renderer_tpu_torch.scene import presets
from optix_renderer_tpu_torch.scene.data import scene_from_numpy


def _carry(js):
    return scene_from_numpy(jax.tree.map(np.asarray, js))


def _films_match(a, b):
    """tests/test_mega.py:203-211's statistic."""
    rel = np.abs(a - b) / (np.abs(a) + 1e-3)
    assert np.median(rel) < 1e-3, np.median(rel)
    assert np.mean(b) == pytest.approx(np.mean(a), rel=0.1)


@pytest.fixture(scope="module")
def cornell():
    js, jc, _ = jmake_cornell_box(width=24, height=16, spp=4)
    return js, jc, _carry(js)


def test_hash_cells_bit_equal():
    r = np.random.default_rng(0)
    c = r.integers(-2**31, 2**31, (4096, 3), dtype=np.int64).astype(np.int32)
    c[:8] = 0
    c[8:16] = -1
    c[16:24] = np.iinfo(np.int32).max
    c[24:32] = np.iinfo(np.int32).min
    c[32:4096:2] = r.integers(-40, 40, (2032, 3))  # small cells of both signs
    for table_size in (1, 2, 1024, 1 << 21, 1 << 30):
        ref = np.asarray(jph._hash_cells(*(jnp.asarray(c[:, i]) for i in range(3)), table_size))
        got = ph._hash_cells(*(torch.from_numpy(c[:, i]) for i in range(3)), table_size)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(ph._hash_cells_np(c, table_size),
                                      jph._hash_cells_np(c, table_size))


def _random_photons(n=500, seed=5):
    """tests/test_photon.py:44-56's photons: positions in [-1,1]^3,
    directions from the upper hemisphere."""
    r = np.random.default_rng(seed)
    pos = r.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.1
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return pos, d, r.uniform(0, 2, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("radius,emitted", [(0.3, 1000), (0.05, 7), (1.7, 123456)])
def test_make_photon_map_bit_equal(radius, emitted):
    pos, d, power = _random_photons(777, seed=int(radius * 100))
    ref = jph.make_photon_map(pos, d, power, radius, emitted)
    got = ph.make_photon_map(pos, d, power, radius, emitted)
    assert got.table_size == ref.table_size
    for k in ref._fields[:-1]:
        a, b = np.asarray(getattr(ref, k)), getattr(got, k).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert ph.make_photon_map(pos[:0], d[:0], power[:0], radius, emitted).pos.shape == (0, 3)


def test_estimate_radiance_matches_jax(cornell, monkeypatch):
    """The JAX map rides in the JAX scene across `scene_from_numpy`; 32 query
    points on a z-up diffuse surface (tests/test_photon.py:44-86), plus 4
    far outside the map's cells."""
    js, _, _ = cornell
    pos, d, power = _random_photons()
    jpm = jph.make_photon_map(pos, d, power, 0.3, 1000)
    ts = _carry(js._replace(photons=jpm))
    q = np.random.default_rng(5).uniform(-0.8, 0.8, (36, 3)).astype(np.float32)
    q[32:] += 5.0
    n = len(q)
    nrm = np.tile(np.float32([0.0, 0.0, 1.0]), (n, 1))
    jits = JInteraction(valid=jnp.ones(n, bool), t=jnp.ones(n), p=jnp.asarray(q),
                        n_s=jnp.asarray(nrm), n_g=jnp.asarray(nrm), uv=jnp.zeros((n, 2)),
                        tang=jnp.zeros((n, 4)), shape=jnp.zeros(n, jnp.int32),
                        prim_kind=jnp.ones(n, jnp.int32), prim_id=jnp.zeros(n, jnp.int32))
    jctx = JCtx(its=jits, frame=jmake_frame(jnp.asarray(nrm)), bsdf_id=jnp.zeros(n, jnp.int32),
                emitter_id=jnp.full(n, -1, jnp.int32))
    ref = np.asarray(jax.jit(lambda c, w: jph.estimate_radiance(jpm, js, c, w))(
        jctx, jnp.asarray(nrm)))
    tn = torch.from_numpy(nrm)
    its = Interaction(valid=torch.ones(n, dtype=torch.bool), t=torch.ones(n),
                      p=torch.from_numpy(q), n_s=tn, n_g=tn, uv=torch.zeros(n, 2),
                      tang=torch.zeros(n, 4), shape=torch.zeros(n, dtype=torch.int32),
                      prim_kind=torch.ones(n, dtype=torch.int32),
                      prim_id=torch.zeros(n, dtype=torch.int32))
    ctx = ShadingCtx(its=its, frame=make_frame(tn), bsdf_id=torch.zeros(n, dtype=torch.int32),
                     emitter_id=torch.full((n,), -1, dtype=torch.int32))
    got = ph.estimate_radiance(ts.photons, ts, ctx, tn).numpy()
    assert (ref[:32] > 0).any(axis=-1).mean() > 0.5 and (ref[32:] == 0).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    # the chunked gather gives the chunks' rows
    monkeypatch.setattr(ph, "GATHER_LANES", 5)
    np.testing.assert_array_equal(ph.estimate_radiance(ts.photons, ts, ctx, tn).numpy(), got)


def _mixed_emitters_xml(tmp_path) -> str:
    """A room lit by a mesh area light, a sphere area light, a point light, a
    constant envmap and two volume lights (in a ball and in a mesh cube)."""
    presets.write_quad_obj(tmp_path, "floor", [(-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)])
    presets.write_quad_obj(tmp_path, "lamp", [(-0.2, 1.9, -0.2), (0.2, 1.9, -0.2),
                                              (0.2, 1.9, 0.2), (-0.2, 1.9, 0.2)])
    corners = [(x, y, z) for z in (-0.8, -0.5) for y in (0.1, 0.4) for x in (0.4, 0.7)]
    corners = [corners[i] for i in (0, 1, 3, 2, 4, 5, 7, 6)]
    (tmp_path / "cube.obj").write_text(
        "".join(f"v {x} {y} {z}\n" for x, y, z in corners)
        + "".join(f"f {a} {b} {c}\n" for a, b, c in presets._CUBE_FACES))
    xml = tmp_path / "mixed.xml"
    xml.write_text(
        '<scene><integrator type="photonmapper"/><camera type="perspective">'
        '<integer name="width" value="8"/><integer name="height" value="6"/>'
        '<transform name="toWorld"><lookat origin="0 1 4" target="0 1 0" up="0 1 0"/>'
        "</transform></camera>"
        '<shape type="obj"><string name="filename" value="floor.obj"/><bsdf type="diffuse"/>'
        "</shape>"
        '<shape type="obj"><string name="filename" value="lamp.obj"/>'
        '<emitter type="area"><color name="radiance" value="5 4 3"/></emitter></shape>'
        '<shape type="sphere"><point name="center" value="-0.5 0.6 0"/>'
        '<float name="radius" value="0.2"/>'
        '<emitter type="area"><color name="radiance" value="2 3 4"/></emitter></shape>'
        '<shape type="sphere"><point name="center" value="0.3 0.5 0.3"/>'
        '<float name="radius" value="0.25"/><medium type="homog" name="interior">'
        '<color name="sigma_a" value="0.5 0.5 0.5"/><color name="sigma_s" value="0 0 0"/>'
        '<emitter type="volumelight"><color name="radiance" value="4 2 1"/></emitter>'
        "</medium></shape>"
        '<shape type="obj"><string name="filename" value="cube.obj"/>'
        '<medium type="homog" name="interior"><color name="sigma_a" value="0.2 0.2 0.2"/>'
        '<color name="sigma_s" value="0 0 0"/>'
        '<emitter type="volumelight"><color name="radiance" value="1 3 2"/></emitter>'
        "</medium></shape>"
        '<emitter type="point"><point name="position" value="0 1.5 1"/>'
        '<color name="power" value="80 70 60"/></emitter>'
        '<emitter type="envmap"><color name="radiance" value="0.3 0.4 0.5"/></emitter>'
        "</scene>")
    return str(xml)


@pytest.mark.parametrize("kind", ["mixed", "image_envmap"])
def test_sample_photon_matches_jax(tmp_path, kind):
    if kind == "mixed":
        xml = _mixed_emitters_xml(tmp_path)
    else:
        xml = str(presets.textured_cornell_xml(tmp_path, 8, 6, 1, "photonmapper"))
    js, _, _ = jload_scene(xml)
    ts = _carry(js)
    types = np.asarray(js.emitters.type)
    want = {"mixed": {0, 2, 3, 5}, "image_envmap": {2, 3}}[kind]
    assert want <= set(types.tolist())
    assert kind == "mixed" or np.asarray(js.envmap.img).shape[0] > 1
    n_em = len(types)
    n = 512 * n_em
    r = np.random.default_rng(11)
    em_id = (np.arange(n) % n_em).astype(np.int32)
    u2a, u2b = r.random((n, 2), np.float32), r.random((n, 2), np.float32)
    u1 = r.random(n, np.float32)
    ref = jax.jit(lambda *a: jph.sample_photon(js, *a))(
        jnp.asarray(em_id), jnp.asarray(u2a), jnp.asarray(u2b), jnp.asarray(u1))
    got = ph.sample_photon(ts, torch.from_numpy(em_id).long(), torch.from_numpy(u2a),
                           torch.from_numpy(u2b), torch.from_numpy(u1))
    for what, a, b in zip(("origin", "direction", "power"), got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-5, err_msg=what)
    w = np.asarray(ref[2])
    for t in want:  # every emitter type of the scene emits photons
        assert (w[types[em_id] == t] > 0).any(), t


def test_trace_photons_matches_jax(cornell):
    js, _, ts = cornell
    n, depth = 4096, 5
    with jax.disable_jit():
        ref = [np.asarray(a) for a in jph.trace_photons(js, n, depth, 1, jnp.uint32(7919))]
    got = [a.numpy() for a in ph.trace_photons(ts, n, depth, 1, 7919)]
    assert got[3].shape == ref[3].shape == (depth, n)
    assert (got[3] != ref[3]).mean() <= 1e-3
    both = got[3] & ref[3]
    assert both[0].mean() > 0.5 and both[depth - 1].any()
    for k, what in enumerate(("pos", "dir", "power")):
        np.testing.assert_allclose(got[k][both], ref[k][both], rtol=1e-4, atol=1e-4,
                                   err_msg=what)


def test_preprocess_keeps_a_carried_map(cornell):
    js, jc, ts = cornell
    cfg = dataclasses.replace(jc, integrator="photonmapper", max_depth=4,
                              iprops=(("photonCount", 3000),))
    assert get_integrator("photonmapper") is li_photonmapper
    pos, d, power = _random_photons()
    carried = _carry(js._replace(photons=jph.make_photon_map(pos, d, power, 0.3, 1000)))
    assert preprocess(carried, cfg, "cpu").photons is carried.photons
    # an empty map is built: 3,000 photons at the auto radius (bbox diagonal / 500)
    built = preprocess(ts, cfg, "cpu").photons
    assert built.pos.shape == (3000, 3) and built.table_size == 8192
    assert float(built.radius) == pytest.approx(ph.auto_radius(ts))
    assert torch.all(built.cell_hash[1:] >= built.cell_hash[:-1])
    # other integrators leave the scene alone
    assert preprocess(ts, dataclasses.replace(cfg, integrator="path_mis"), "cpu") is ts


def _pmap_config(jc, w, h, photons, depth=8):
    return dataclasses.replace(jc, width=w, height=h, integrator="photonmapper", max_depth=depth,
                               iprops=(("photonCount", photons), ("photonRadius", 0.12)))


def test_photonmapper_film_with_jax_map_matches_jax(cornell):
    """24×16, depth 8, 4 spp: the JAX render and the port's on the same map
    (built by the JAX package and carried across)."""
    js, jc, _ = cornell
    cfg = _pmap_config(jc, 24, 16, 6000)
    jpm = jph.build_photon_map(js, 6000, 0.12, cfg.max_depth, 1, seed=cfg.seed)
    jscene = js._replace(photons=jpm)
    ref = jrender(jscene, cfg, sample_count=4)
    out = render(_carry(jscene), cfg, sample_count=4, device="cpu")
    assert out["composite"].mean() > 0
    _films_match(out["composite"], np.asarray(ref["composite"]))
    np.testing.assert_allclose(out["albedo"], np.asarray(ref["albedo"]), atol=1e-5)


def test_photonmapper_film_means_match_jax():
    """tests/test_photon.py:88-99's configuration, each package building its
    own map with its own trace: 48×48, depth 8, 20,000 photons of radius
    0.12, 4 spp."""
    js, jc, _ = jmake_cornell_box(width=48, height=48, spp=8)
    cfg = _pmap_config(jc, 48, 48, 20000)
    ref = float(np.asarray(jrender(js, cfg, sample_count=4)["composite"]).mean())
    ts, tc, _ = presets.make_cornell_box(width=48, height=48, spp=8, device="cpu")
    got = render(ts, _pmap_config(tc, 48, 48, 20000), sample_count=4, device="cpu")
    assert got["composite"].shape == (48, 48, 3)
    assert abs(float(got["composite"].mean()) - ref) <= 0.05 * ref, (got["composite"].mean(), ref)


@pytest.mark.parametrize("entry", ["render", "render_adaptive"])
def test_entry_points_run_preprocess(cornell, monkeypatch, entry):
    """`render()` and `render_adaptive` build the photon map once per call
    through `preprocess`, and use a carried map as is."""
    from optix_renderer_tpu_torch.render import adaptive

    _, jc, ts = cornell
    cfg = dataclasses.replace(_pmap_config(jc, 16, 12, 3000, depth=4), adaptive=True)
    fn = {"render": render, "render_adaptive": adaptive.render_adaptive}[entry]
    built = []
    build = ph.build_photon_map
    monkeypatch.setattr(ph, "build_photon_map", lambda *a, **k: built.append(1) or build(*a, **k))
    out = fn(ts, cfg, sample_count=6, device="cpu")
    assert built == [1] and out["composite"].mean() > 0
    carried = dataclasses.replace(ts, photons=ph.make_photon_map(*_random_photons(), 0.3, 1000))
    fn(carried, cfg, sample_count=2, device="cpu")
    assert built == [1]
