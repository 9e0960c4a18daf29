"""Adaptive sampling in the port (`render/adaptive.py`, `render/variance.py`,
`core/rng.py: lcg_*`) against the JAX package, on the CPU.

* the LCG bit for bit over 4,096 states; `variance_from_image` on one film
  to 1e-6; `_draw_pixels` on one variance map: at least 99.9 % of the ids
  equal (the port builds the draw's CDF in float64 on the host, the JAX
  package in float32 through XLA, so a uniform within a few ulps of a cell
  boundary may land in the neighbouring pixel);
* the four tests of tests/test_adaptive.py on the port;
* `render_adaptive` on the 24×24 furnace against the JAX one: the same
  `samples_placed` and composite means within 1 % at 8 spp. The films
  differ in their last bits (XLA contracts multiply-adds on the CPU), so
  the variance maps do too, and from the first pixel that a draw places
  differently the two renders follow different random walks; a stop test
  whose margin lies within that noise can then fire a round apart (one
  of the furnace's stop tests at 16 spp does). At 8 spp no stop test is
  that close; at 16 spp both renders must stop before the budget;
* the CLI renders a `<sampler type="adaptive">` scene and writes
  `_variance.exr`; `render()` renders an adaptive config uniformly on the
  scan path, bit for bit the `mega=False` render.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.core import rng as jrng
from optix_renderer_tpu.render.adaptive import _draw_pixels as jdraw_pixels
from optix_renderer_tpu.render.adaptive import render_adaptive as jrender_adaptive
from optix_renderer_tpu.render.variance import variance_from_image as jvariance_from_image
from optix_renderer_tpu.scene.presets import make_furnace
from optix_renderer_tpu_torch import cli
from optix_renderer_tpu_torch.core import rng
from optix_renderer_tpu_torch.ops.cuda.pathk import pathk_eligible
from optix_renderer_tpu_torch.render.adaptive import _draw_pixels, render_adaptive
from optix_renderer_tpu_torch.render.render import render
from optix_renderer_tpu_torch.render.variance import variance_from_image
from optix_renderer_tpu_torch.scene.data import scene_from_numpy
from optix_renderer_tpu_torch.scene.presets import cornell_box_xml, make_cornell_box
from optix_renderer_tpu_torch.utils.imageio import read_exr


def _furnace(**kw):
    """The JAX furnace preset and the same scene carried into the port."""
    js, jc, _ = make_furnace(**kw)
    return js, jc, scene_from_numpy(jax.tree.map(np.asarray, js))


def _film(seed=1, h=24, w=32):
    """A weighted film [H,W,4] with varying weights."""
    r = np.random.default_rng(seed)
    f = r.uniform(0.0, 2.0, (h, w, 4)).astype(np.float32)
    f[..., 3] = r.uniform(0.5, 4.0, (h, w))
    return f


def test_lcg_matches_jax():
    """`lcg_step` and `lcg_next_float` bit for bit on 4,096 states,
    including 0 and 2^32 − 1."""
    states = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    states[:2] = (0, 2**32 - 1)
    js = jnp.asarray(states.astype(np.uint32))
    ts = torch.from_numpy(states.astype(np.int64))
    np.testing.assert_array_equal(rng.lcg_step(ts).numpy(),
                                  np.asarray(jrng.lcg_step(js)).astype(np.int64))
    jstate, ju = jrng.lcg_next_float(js)
    tstate, tu = rng.lcg_next_float(ts)
    np.testing.assert_array_equal(tstate.numpy(), np.asarray(jstate).astype(np.int64))
    assert tu.dtype == torch.float32
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


def test_variance_from_image_matches_jax():
    """The normalized 3×3 variance map of one film, and 0 on a flat film."""
    f = _film()
    got = variance_from_image(torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, np.asarray(jvariance_from_image(jnp.asarray(f))),
                               rtol=1e-6, atol=1e-6)
    flat = np.ones((8, 8, 4), np.float32)
    assert not variance_from_image(torch.from_numpy(flat)).any()


def test_draw_pixels_matches_jax():
    """One round's 65,536 draws over a 24×32 variance map: ≥ 99.9 % of the
    ids equal JAX's (float64 against float32 CDF, module docstring)."""
    var = np.asarray(jvariance_from_image(jnp.asarray(_film(seed=2))))
    n = 1 << 16
    want = np.asarray(jdraw_pixels(jnp.asarray(var), jnp.int32(5), n, 7))
    got = _draw_pixels(torch.from_numpy(var.copy()), 5, n, 7).numpy()
    assert got.shape == (n,) and got.min() >= 0 and got.max() < var.size
    assert (got == want).mean() >= 0.999


def test_draw_pixels_follows_variance():
    """The draw concentrates on a high-variance pixel and spreads over a
    uniform map (tests/test_adaptive.py)."""
    h, w = 8, 8
    var = torch.full((h, w), 1e-6)
    var[3, 5] = 1.0
    hot = 3 * w + 5
    assert (_draw_pixels(var, 1, 4096).numpy() == hot).mean() > 0.9
    assert (_draw_pixels(torch.ones(h, w), 2, 4096).numpy() == hot).mean() < 0.1


def test_adaptive_stops_on_converged_scene():
    """The furnace converges, so the stop fires before the budget, after at
    least the uniform rounds."""
    _, jc, scene = _furnace(width=24, height=24, spp=16)
    config = dataclasses.replace(jc, adaptive=True, adaptive_uniform_rounds=2, max_depth=4,
                                 sample_count=16)
    out = render_adaptive(scene, config, device="cpu")
    n_pix = 24 * 24
    assert 2 * n_pix <= out["samples_placed"] < 16 * n_pix


def test_adaptive_matches_uniform_mean():
    """Adaptive placement stays unbiased: the furnace's mean matches the
    uniform render's within 5 %."""
    _, jc, scene = _furnace(albedo=0.5, radiance=1.0, width=16, height=16, spp=12)
    config = dataclasses.replace(jc, max_depth=16, sample_count=12)
    ref = render(scene, config, device="cpu")
    out = render_adaptive(scene, dataclasses.replace(config, adaptive=True,
                                                     adaptive_uniform_rounds=3), device="cpu")
    mean_u, mean_a = float(np.mean(ref["composite"])), float(np.mean(out["composite"]))
    assert abs(mean_a - mean_u) < 0.05 * max(mean_u, 1e-6), (mean_a, mean_u)


def test_adaptive_weights_written():
    """The weight channel records where samples landed, and the film is
    finite."""
    scene, config, _ = make_cornell_box(16, 12, 6, "path_mis", device="cpu")
    config = dataclasses.replace(config, adaptive=True, adaptive_uniform_rounds=2, max_depth=3)
    out = render_adaptive(scene, config, device="cpu")
    assert out["weights"].shape == (12, 16) and out["variance"].shape == (12, 16)
    assert np.all(out["weights"] > 0.0)
    assert np.isfinite(out["composite"]).all()


def test_render_adaptive_matches_jax_on_furnace():
    """The 24×24 furnace, 2 uniform rounds, depth 4: at 8 spp the same
    samples placed and means within 1 %; at 16 spp both stop early and
    their means agree within 1 % (module docstring)."""
    js, jc, scene = _furnace(width=24, height=24, spp=16)
    for spp in (8, 16):
        config = dataclasses.replace(jc, adaptive=True, adaptive_uniform_rounds=2, max_depth=4,
                                     sample_count=spp)
        want = jrender_adaptive(js, config)
        got = render_adaptive(scene, config, device="cpu")
        if spp == 8:
            assert got["samples_placed"] == want["samples_placed"] == 8 * 24 * 24
        else:
            assert max(got["samples_placed"], want["samples_placed"]) < 16 * 24 * 24
        m_got, m_want = float(got["composite"].mean()), float(want["composite"].mean())
        assert abs(m_got - m_want) <= 0.01 * m_want, (spp, m_got, m_want)


def test_cli_writes_variance_exr(tmp_path):
    """`<sampler type="adaptive">` builds with `adaptive` set, the CLI
    renders it adaptively and writes the EXR, the PNG and `_variance.exr`;
    `--no-adaptive` writes no variance image."""
    xml = cornell_box_xml(tmp_path, 16, 12, 6, "path_mis", sampler="adaptive")
    out = tmp_path / "adaptive"
    assert cli.main(["render", str(xml), "--device", "cpu", "--depth", "3", "-o", str(out)]) == 0
    var = read_exr(str(out) + "_variance.exr")
    assert var.shape[:2] == (12, 16) and np.isfinite(var).all() and var.max() > 0
    assert read_exr(out.with_suffix(".exr")).shape[:2] == (12, 16)
    assert out.with_suffix(".png").stat().st_size > 0
    plain = tmp_path / "plain"
    assert cli.main(["render", str(xml), "--device", "cpu", "--depth", "3", "--no-adaptive",
                     "-o", str(plain)]) == 0
    assert not (tmp_path / "plain_variance.exr").exists()


def test_render_of_an_adaptive_config_is_the_uniform_scan_render(tmp_path):
    """`render()` keeps an adaptive config off the path kernel and renders
    it uniformly on the scan path: bit for bit the `mega=False` render."""
    from optix_renderer_tpu_torch.scene.build import load_scene

    scene, config, _ = load_scene(cornell_box_xml(tmp_path, 16, 12, 2, "path_mis",
                                                  sampler="adaptive"), device="cpu")
    assert config.adaptive and not pathk_eligible(scene, config)
    config = dataclasses.replace(config, max_depth=3)
    uniform = dataclasses.replace(config, adaptive=False)
    assert pathk_eligible(scene, uniform)
    got = render(scene, config, device="cpu")
    want = render(scene, uniform, device="cpu", mega=False)
    for key in ("composite", "albedo", "normal", "weights"):
        assert np.array_equal(got[key], want[key]), key
