"""The port's volumetric integrators and media scenes against the JAX
package's, on the CPU.

* per lane: `li_vol` (path_vol_mats and path_vol_mis) against the JAX
  `li_vol` run op by op (`jax.disable_jit`, so XLA contracts no
  multiply-adds across ops), on 4,096 camera rays of configs H
  (heterogeneous, a 16³ grid) and V (homogeneous, a volume light) at depth
  2, the same sampler state in; L, albedo and normal to 1e-5 relative and
  5e-6 absolute except on at most 0.1 % of the lanes (the rule of
  tests/test_torch_simple.py), and the sampler advanced by the same draws;
* films at 24×16, box filter, depth 3, against `render(mega=False)` of the
  JAX package by tests/test_mega.py:182-211's median statistic;
* the committed golden `absorb_vol_mis` (tools/gen_golden.py's config)
  through the port by the rule of tests/test_torch_general.py, and
  Beer–Lambert on the absorbing sphere: exp(−σa·2r) on its centre;
* a constant heterogeneous grid renders as the equal homogeneous medium
  (tests/test_heterog.py:138), the emissive ball and temperature emission
  against their analytic radiance (tests/test_volumelight.py:152, 177);
* every media feature of the XML builder (the media zoo of
  tests/test_torch_media.py, configs H and V) built by the port equals
  `scene_from_numpy` of the JAX build, field by field.
"""

import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.core.math import Ray as JRay
from optix_renderer_tpu.integrators import volpath as jvolpath
from optix_renderer_tpu.render import sampler as jsmp
from optix_renderer_tpu.render.render import render as jrender
from optix_renderer_tpu.scene import build as jbuild
from optix_renderer_tpu_torch.core.math import Ray
from optix_renderer_tpu_torch.integrators import get_integrator, volpath
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.render.film import in_footprints
from optix_renderer_tpu_torch.render.render import render
from optix_renderer_tpu_torch.scene import build, presets
from optix_renderer_tpu_torch.scene.data import scene_from_numpy
from optix_renderer_tpu_torch.utils.imageio import read_exr
from test_torch_media import CUBE_OBJ, media_zoo_xml

GOLDEN = Path(__file__).resolve().parent / "golden"
N_LANES = 4096


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    """Configs H (16³ grid) and V at 24×16, as XML, JAX scene, JAX config
    and the JAX scene carried across."""
    out = {}
    for kind in "HV":
        xml = presets.medium_cornell_xml(tmp_path_factory.mktemp(kind), 24, 16, 1, "path_vol_mis",
                                         kind, res=16)
        js, jc, _ = jbuild.load_scene(str(xml))
        out[kind] = (xml, js, jc, scene_from_numpy(jax.tree.map(np.asarray, js)))
    return out


def _camera_rays(n):
    """From the Cornell camera's eye into the room."""
    r = np.random.default_rng(11)
    o = np.tile(np.array([[0.0, 1.0, 4.3]], np.float32), (n, 1))
    d = r.uniform((-1, 0, -1), (1, 2, 0.5), (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d, np.full(n, 1e-4, np.float32), np.full(n, np.inf, np.float32)


@pytest.mark.parametrize("kind", ["H", "V"])
@pytest.mark.parametrize("mis", [False, True])
def test_li_vol_lanes_match_jax(configs, kind, mis):
    _, js, jc, ts = configs[kind]
    cfg = dataclasses.replace(jc, max_depth=2)
    rays = _camera_rays(N_LANES)
    pix = np.arange(N_LANES, dtype=np.int64)
    jsamp = jsmp.make_sampler(jnp.asarray(pix, jnp.int32).astype(jnp.uint32), jnp.uint32(3),
                              seed=5)
    tsamp = smp.make_sampler(torch.from_numpy(pix), 3, seed=5)
    with jax.disable_jit():
        ref = jvolpath.li_vol(js, cfg, JRay(*map(jnp.asarray, rays)), jsamp, use_mis=mis)
    got = volpath.li_vol(ts, cfg, Ray(*map(torch.from_numpy, rays)), tsamp, use_mis=mis)
    for k, what in enumerate(("L", "albedo", "normal")):
        a, b = got[k].numpy().astype(np.float64), np.asarray(ref[k], np.float64)
        off = (np.abs(a - b) > 5e-6 + 1e-5 * np.abs(b)).any(axis=-1)
        assert off.mean() <= 1e-3, (what, int(off.sum()), float(np.abs(a - b).max()))
    assert float(np.asarray(ref[0]).mean()) > 0
    np.testing.assert_array_equal(smp.next_1d(got[3])[1].numpy(),
                                  np.asarray(jsmp.next_1d(ref[3])[1]))


def _films_match(a, b):
    """tests/test_mega.py:203-211's statistic."""
    rel = np.abs(a - b) / (np.abs(a) + 1e-3)
    assert np.median(rel) < 1e-3, np.median(rel)
    assert np.mean(b) == pytest.approx(np.mean(a), rel=0.1)


@pytest.mark.parametrize("kind,integ", [("H", "path_vol_mis"), ("V", "path_vol_mats")])
def test_film_matches_jax(configs, kind, integ):
    xml, js, jc, _ = configs[kind]
    ts, tc, _ = build.load_scene(xml, device="cpu")
    jc = dataclasses.replace(jc, integrator=integ, max_depth=3, rfilter="box")
    tc = dataclasses.replace(tc, integrator=integ, max_depth=3, rfilter="box")
    ref = jrender(js, jc, sample_count=1, mega=False, wavefront=False)
    got = render(ts, tc, sample_count=1, device="cpu", mega=False)
    for layer in ("composite", "albedo", "normal"):
        _films_match(np.asarray(ref[layer]), got[layer])
    np.testing.assert_array_equal(got["weights"], np.asarray(ref["weights"]))


def test_absorbing_sphere_reproduces_golden():
    """tools/gen_golden.py's `absorb_vol_mis` (48×48, 8 spp, gaussian, depth
    6): max |a−b|/(|ref|+1e-2) < 1e-3, or every pixel over it inside two
    filter footprints, the median < 1e-4 and the means within 1e-3."""
    scene, config, _ = presets.make_absorbing_sphere(width=48, height=48, spp=1,
                                                     integrator="path_vol_mis", device="cpu")
    config = dataclasses.replace(config, max_depth=6, rfilter="gaussian")
    out = render(scene, config, sample_count=8, device="cpu")["composite"]
    ref = read_exr(GOLDEN / "absorb_vol_mis.exr")[..., :3]
    err = (np.abs(out - ref) / (np.abs(ref) + 1e-2)).max(axis=-1)
    if err.max() >= 1e-3:
        assert in_footprints(err > 1e-3, "gaussian", 2), np.argwhere(err > 1e-3)
        assert np.median(err) < 1e-4, np.median(err)
        assert out.mean() == pytest.approx(ref.mean(), rel=1e-3)


@pytest.mark.parametrize("integ", ["path_vol_mats", "path_vol_mis"])
def test_beer_lambert(integ):
    """Through the absorbing sphere's centre the radiance is exp(−σa·2r):
    8,192 central rays through the integrator (3σ of the Bernoulli mean
    ≈ 0.016), the centre 4×4 pixels of a 16×16 × 16-spp render within 0.1
    (3σ of 256 samples ≈ 0.09; their chords are 2 % shorter), and the
    background exactly 1."""
    sigma_a, radius = 0.5, 1.0
    scene, config, _ = presets.make_absorbing_sphere(sigma_a, radius, 16, 16, 16, integ,
                                                     device="cpu")
    config = dataclasses.replace(config, max_depth=4)
    want = np.exp(-sigma_a * 2 * radius)
    n = 8192
    ray = Ray(o=torch.tensor([0.0, 0.0, 6.0]).expand(n, 3),
              d=torch.tensor([0.0, 0.0, -1.0]).expand(n, 3),
              mint=torch.zeros(n), maxt=torch.full((n,), float("inf")))
    L = get_integrator(integ)(scene, config, ray, smp.make_sampler(torch.arange(n), 0))[0]
    assert abs(float(L[:, 0].mean()) - want) < 0.02
    img = render(scene, config, device="cpu")["composite"]
    assert abs(img[6:10, 6:10].mean() - want) < 0.1
    assert abs(img[0, 0].mean() - 1.0) < 1e-3


def _cube_scene(tmp_path, medium: str, density=None) -> tuple:
    """tests/test_heterog.py's scene: the unit cube as a pass-through box
    holding `medium` (σa 1, σs 3) lit by a point light, path_vol_mis."""
    if density is not None:
        np.savez(tmp_path / "vol.npz", density=density,
                 bbox_min=np.full(3, -0.5, np.float32), bbox_max=np.full(3, 0.5, np.float32))
    (tmp_path / "cube.obj").write_text(CUBE_OBJ)
    vol = ('<volume type="volume"><string name="filename" value="vol.npz"/></volume>'
           if medium == "heterog" else "")
    xml = tmp_path / f"{medium}.xml"
    xml.write_text(
        '<scene><integrator type="path_vol_mis"/><camera type="perspective">'
        '<float name="fov" value="35"/><transform name="toWorld">'
        '<lookat target="0,0,0" origin="0,-2.5,0" up="0,0,1"/></transform>'
        '<integer name="width" value="16"/><integer name="height" value="16"/></camera>'
        f'<shape type="obj"><string name="filename" value="cube.obj"/><medium type="{medium}">'
        '<color name="sigma_a" value="1 1 1"/><color name="sigma_s" value="3 3 3"/>'
        f"{vol}</medium></shape>"
        '<emitter type="point"><point name="position" value="0,-2,2"/>'
        '<color name="power" value="400,400,400"/></emitter></scene>')
    scene, config, _ = build.load_scene(xml, device="cpu")
    return scene, dataclasses.replace(config, max_depth=6)


def test_constant_heterog_matches_homog(tmp_path):
    """A constant-density heterogeneous cube renders as the homogeneous
    cube of the same σ, within 10 % in the mean (tests/test_heterog.py:138)."""
    het = render(*_cube_scene(tmp_path, "heterog", np.ones((8, 8, 8), np.float32)),
                 sample_count=12, device="cpu")["composite"].mean()
    hom = render(*_cube_scene(tmp_path, "homog"), sample_count=12, device="cpu")["composite"].mean()
    assert het > 0 and abs(het - hom) / hom < 0.1, (het, hom)


def test_emissive_ball_direct_view_analytic(tmp_path):
    """A purely absorbing emissive ball seen head-on: the radiance along its
    central ray is ε(1 − e^(−σa·2R))/σa (tests/test_volumelight.py:152)."""
    (tmp_path / "plane.obj").write_text("v -3 -3 0\nv 3 -3 0\nv 3 3 0\nv -3 3 0\nf 1 2 3\nf 1 3 4\n")
    xml = tmp_path / "ball.xml"
    xml.write_text(
        '<scene><integrator type="path_vol_mats"/><camera type="perspective">'
        '<integer name="width" value="8"/><integer name="height" value="8"/></camera>'
        '<shape type="sphere"><point name="center" value="0 0 0.75"/>'
        '<float name="radius" value="0.5"/><medium type="homog">'
        '<color name="sigma_a" value="2 2 2"/><color name="sigma_s" value="0 0 0"/>'
        '<emitter type="volumelight"><color name="radiance" value="3 3 3"/></emitter>'
        '</medium></shape><shape type="obj"><string name="filename" value="plane.obj"/>'
        '<bsdf type="diffuse"><color name="albedo" value="1 1 1"/></bsdf></shape></scene>')
    scene, config, _ = build.load_scene(xml, device="cpu")
    n = 4096
    ray = Ray(o=torch.tensor([0.0, -4.0, 0.75]).expand(n, 3),
              d=torch.tensor([0.0, 1.0, 0.0]).expand(n, 3),
              mint=torch.zeros(n), maxt=torch.full((n,), float("inf")))
    L = volpath.li_vol(scene, dataclasses.replace(config, max_depth=8), ray,
                       smp.make_sampler(torch.arange(n), 0), use_mis=False)[0]
    want = 3.0 * (1.0 - np.exp(-2.0)) / 2.0
    assert abs(float(L[:, 0].mean()) - want) / want < 0.05


def test_temperature_emission_analytic(tmp_path):
    """A constant heterogeneous slab with a constant temperature: the
    central ray's radiance is ε(1 − e^(−σt·L))/σt with ε = σa·ρ·ramp(T)·scale
    (tests/test_volumelight.py:177)."""
    t_val, t_scale, sa = 0.8, 5.0, 1.0
    np.savez(tmp_path / "vol.npz", density=np.ones((64, 64, 64), np.float32),
             temperature=np.full((64, 64, 64), t_val, np.float32),
             bbox_min=np.full(3, -0.5, np.float32), bbox_max=np.full(3, 0.5, np.float32))
    (tmp_path / "cube.obj").write_text(CUBE_OBJ)
    xml = tmp_path / "slab.xml"
    xml.write_text(
        '<scene><integrator type="path_vol_mats"/><camera type="perspective">'
        '<integer name="width" value="8"/><integer name="height" value="8"/></camera>'
        '<shape type="obj"><string name="filename" value="cube.obj"/><medium type="heterog">'
        f'<color name="sigma_a" value="{sa} {sa} {sa}"/><color name="sigma_s" value="0 0 0"/>'
        f'<float name="temperatureScale" value="{t_scale}"/>'
        '<volume type="volume"><string name="filename" value="vol.npz"/></volume>'
        "</medium></shape></scene>")
    scene, config, _ = build.load_scene(xml, device="cpu")
    n = 4096
    ray = Ray(o=torch.tensor([0.0, -3.0, 0.0]).expand(n, 3),
              d=torch.tensor([0.0, 1.0, 0.0]).expand(n, 3),
              mint=torch.zeros(n), maxt=torch.full((n,), float("inf")))
    L = volpath.li_vol(scene, dataclasses.replace(config, max_depth=6), ray,
                       smp.make_sampler(torch.arange(n), 0), use_mis=False)[0]
    ramp = np.array([t_val ** 3, t_val ** 6, t_val ** 12]) * t_scale
    want = sa * ramp * (1.0 - np.exp(-sa)) / sa
    np.testing.assert_allclose(L.numpy().mean(axis=0), want, rtol=0.06)


def _assert_same_tables(a, b, path="scene"):
    """Every field of two scenes' tables equal (float tables to 1e-6)."""
    if dataclasses.is_dataclass(a) or hasattr(a, "_fields"):  # tables, the photon map
        assert type(a) is type(b), path
        for name in a._fields if isinstance(a, tuple) else [f.name for f in dataclasses.fields(a)]:
            _assert_same_tables(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6, err_msg=path)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("kind", ["zoo", "H", "V"])
def test_builder_matches_jax(tmp_path, kind):
    """The port's builder against the JAX builder carried across, field by
    field: media rows and phase functions (Schlick's k = 1.55g − 0.55g³),
    pass-through shapes without a BSDF, interior / exterior media, the
    ambient medium, volume lights (ball and bbox), the padded corner stacks."""
    if kind == "zoo":
        xml = media_zoo_xml(tmp_path)
    else:
        xml = str(presets.medium_cornell_xml(tmp_path, 24, 16, 1, "path_vol_mis", kind, res=16))
    js, jc, _ = jbuild.load_scene(xml)
    ts, tc, _ = build.load_scene(xml, device="cpu")
    _assert_same_tables(ts, scene_from_numpy(jax.tree.map(np.asarray, js)))
    assert (tc.n_emitters, tc.n_tris, tc.shadow_segments) == (jc.n_emitters, jc.n_tris,
                                                              jc.shadow_segments)
    if kind == "zoo":
        assert ts.ambient_medium >= 0 and (ts.shapes.bsdf == -1).sum() == 5
        assert ts.media.phase_type.tolist()[:3] == [0, 1, 2]
        assert ts.shapes.exterior_medium.max() >= 0
