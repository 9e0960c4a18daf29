"""The port's single-bounce integrators (`integrators/simple.py`) against the
JAX package's, on the CPU.

* per lane: the JAX Cornell box carried across by `scene_from_numpy`, the
  same numpy-seeded rays and the same sampler state through each of the
  eight JAX `li_*` and the port's; L, albedo and normal to 1e-5 relative
  and 5e-6 absolute, except on at most 0.1 % of the lanes (over 1e-3 there):
  XLA on the CPU contracts multiply-adds into FMAs and torch does not, so a
  rare lane takes another branch at a grazing hit or a light's edge
  (ROADMAP Queue 3);
* films: `render(mega=False)` against the JAX package's, box filter, by
  tests/test_mega.py:182-211's median statistic;
* the committed goldens `cbox_direct_mis` and `cbox_normals`
  (tools/gen_golden.py's config) through the port's scan path, by the rule
  of tests/test_torch_general.py.
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
from optix_renderer_tpu.integrators import simple as jsimple
from optix_renderer_tpu.render import sampler as jsmp
from optix_renderer_tpu.render.render import render as jrender
from optix_renderer_tpu.scene import build as jbuild
from optix_renderer_tpu.scene import presets as jpresets
from optix_renderer_tpu_torch.core.math import Ray
from optix_renderer_tpu_torch.integrators import get_integrator
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.render.film import in_footprints
from optix_renderer_tpu_torch.render.render import render
from optix_renderer_tpu_torch.scene import presets
from optix_renderer_tpu_torch.scene.data import scene_from_numpy
from optix_renderer_tpu_torch.utils.imageio import read_exr

pytestmark = pytest.mark.heavy

GOLDEN = Path(__file__).resolve().parent / "golden"
INTEGRATORS = ["normals", "av", "direct", "direct_ems", "direct_mats", "direct_mis", "preview",
               "envmaptester"]
N_LANES = 4096


@pytest.fixture(scope="module")
def cornell(tmp_path_factory):
    """The Cornell box with a constant envmap added (so that misses and
    `envmaptester` see light), built by the JAX package and carried across."""
    xml = presets.cornell_box_xml(tmp_path_factory.mktemp("cbox"), 24, 16, 1)
    xml.write_text(xml.read_text().replace(
        "</scene>", '<emitter type="envmap"><color name="radiance" value="0.3 0.4 0.5"/>'
                    "</emitter></scene>"))
    js, jc, _ = jbuild.load_scene(str(xml))
    assert jc.n_emitters == 2
    return js, jc, scene_from_numpy(jax.tree.map(np.asarray, js))


def _rays(n):
    """Half from the camera's eye into the box, half from inside it in every
    direction (some leave through the open front)."""
    rng = np.random.default_rng(11)
    o = np.where(rng.uniform(size=(n, 1)) < 0.5, np.array([[0.0, 1.0, 4.3]]),
                 rng.uniform((-0.9, 0.1, -0.9), (0.9, 1.9, 0.9), (n, 3))).astype(np.float32)
    target = rng.uniform((-1, 0, -1), (1, 2, 0.5), (n, 3))
    d = np.where(o[:, 2:3] > 4, target - o, rng.normal(size=(n, 3)))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    mint = np.full(n, 1e-4, np.float32)
    maxt = np.full(n, np.inf, np.float32)
    return o, d, mint, maxt


def _lanes_close(got, ref, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    off = (diff > 5e-6 + 1e-5 * np.abs(ref)).any(axis=-1)
    assert off.mean() <= 1e-3, (what, int(off.sum()), float(diff.max()))
    return int(off.sum())


@pytest.mark.parametrize("name", INTEGRATORS)
def test_integrator_lanes_match_jax(cornell, name):
    js, jc, ts = cornell
    rays = _rays(N_LANES)
    pix = np.arange(N_LANES, dtype=np.int64)
    jsamp = jsmp.make_sampler(jnp.asarray(pix, jnp.int32).astype(jnp.uint32), jnp.uint32(3),
                              seed=5)
    tsamp = smp.make_sampler(torch.from_numpy(pix), 3, seed=5)
    # op by op, as the JAX scan path's ops run: under one `jax.jit` XLA fuses
    # across them and contracts more multiply-adds, and ~2 % of the lanes
    # move past 1e-5
    ref = getattr(jsimple, f"li_{name}")(js, jc, JRay(*map(jnp.asarray, rays)), jsamp)
    got = get_integrator(name)(ts, jc, Ray(*map(torch.from_numpy, rays)), tsamp)
    for k, what in enumerate(("L", "albedo", "normal")):
        _lanes_close(got[k].numpy(), ref[k], f"{name} {what}")
    if name != "envmaptester":
        assert float(np.asarray(ref[0]).mean()) > 0
    # the sampler advanced by the same draws
    np.testing.assert_array_equal(smp.next_1d(got[3])[1].numpy(),
                                  np.asarray(jsmp.next_1d(ref[3])[1]))


def _films_match(a, b):
    """tests/test_mega.py:203-211's statistic."""
    rel = np.abs(a - b) / (np.abs(a) + 1e-3)
    assert np.median(rel) < 1e-3, np.median(rel)
    assert np.mean(b) == pytest.approx(np.mean(a), rel=0.1)


@pytest.mark.parametrize("name", ["direct_mis", "direct", "av"])
def test_film_matches_jax(name):
    js, jc, _ = jpresets.make_cornell_box(24, 16, 1, name)
    ts, tc, _ = presets.make_cornell_box(24, 16, 1, name, device="cpu")
    jc, tc = dataclasses.replace(jc, rfilter="box"), dataclasses.replace(tc, rfilter="box")
    ref = jrender(js, jc, sample_count=4, mega=False, wavefront=False)
    got = render(ts, tc, sample_count=4, device="cpu", mega=False)
    for layer in ("composite", "albedo", "normal"):
        _films_match(np.asarray(ref[layer]), got[layer])
    np.testing.assert_array_equal(got["weights"], np.asarray(ref["weights"]))


@pytest.mark.parametrize("name", ["direct_mis", "normals"])
def test_scan_path_reproduces_goldens(name):
    """tools/gen_golden.py's config (64×48, 8 spp, gaussian, depth 4): max
    |a−b|/(|ref|+1e-2) < 1e-3, or, where a sample takes another branch than
    in the JAX film, every pixel over the bound inside two filter footprints,
    the median < 1e-4 and the means within 1e-3 (tests/test_torch_general.py)."""
    scene, config, _ = presets.make_cornell_box(64, 48, 1, name, device="cpu")
    config = dataclasses.replace(config, max_depth=4, rfilter="gaussian")
    out = render(scene, config, sample_count=8, device="cpu", mega=False)["composite"]
    ref = read_exr(GOLDEN / f"cbox_{name}.exr")[..., :3]
    err = (np.abs(out - ref) / (np.abs(ref) + 1e-2)).max(axis=-1)
    if err.max() >= 1e-3:
        assert in_footprints(err > 1e-3, "gaussian", 2), np.argwhere(err > 1e-3)
        assert np.median(err) < 1e-4, np.median(err)
        assert out.mean() == pytest.approx(ref.mean(), rel=1e-3)
