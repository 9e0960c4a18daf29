"""Wavefront path regeneration in the port (`render/wavefront.py`,
`render(..., wavefront=True)`, `film.splat_(..., mask)`) on the CPU.

* against the JAX `render_wavefront` on the 24×16 Cornell box at depth 6,
  2 spp, 128 lanes refilled every iteration, the host reading the counters
  every 2 (several refill generations): the port's scan films' statistic
  against JAX (tests/test_torch_general.py: `_films_match`), since XLA
  contracts multiply-adds on the CPU and torch does not;
* against the port's own scan path with the box filter, bit for bit: each
  path's arithmetic is the scan's and each pixel adds its two samples of
  weight 1, which commute; with the gaussian filter to the JAX test's
  tolerance (tests/test_wavefront.py), the order of additions only;
* a pool larger than the work, the dispatch of `render()`, the
  intersections per iteration, and the masked splat.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.render import film as jfilm
from optix_renderer_tpu.render.wavefront import render_wavefront as jrender_wavefront
from optix_renderer_tpu.scene.presets import make_cornell_box as jmake_cornell_box
from optix_renderer_tpu_torch.ops.cuda import isect
from optix_renderer_tpu_torch.ops.cuda.pathk import pathk_eligible
from optix_renderer_tpu_torch.render import film
from optix_renderer_tpu_torch.render import mega_render
from optix_renderer_tpu_torch.render import wavefront as wf
from optix_renderer_tpu_torch.render.render import render
from optix_renderer_tpu_torch.scene.presets import make_cornell_box

LAYERS = ("composite", "albedo", "normal", "weights")


def _cornell(integrator, rfilter=None, depth=6):
    scene, config, _ = make_cornell_box(24, 16, 2, integrator, device="cpu")
    config = dataclasses.replace(config, max_depth=depth, rfilter=rfilter or config.rfilter)
    return scene, config


def _films_match(a, b):
    """tests/test_mega.py:203-211's statistic."""
    rel = np.abs(a - b) / (np.abs(a) + 1e-3)
    assert np.median(rel) < 1e-3, np.median(rel)
    assert np.mean(b) == pytest.approx(np.mean(a), rel=0.1)


@pytest.fixture(scope="module", params=["path_mis", "path_mats"])
def jax_pair(request):
    js, jc, _ = jmake_cornell_box(24, 16, 2, request.param)
    jc = dataclasses.replace(jc, max_depth=6)
    ref = jrender_wavefront(js, jc, sample_count=2, n_lanes=128, sync_every=2)
    scene, config = _cornell(request.param)
    got = wf.render_wavefront(scene, config, sample_count=2, n_lanes=128, sync_every=2,
                              device="cpu")
    return ref, got


@pytest.mark.parametrize("layer", LAYERS)
def test_wavefront_matches_jax(jax_pair, layer):
    ref, got = jax_pair
    assert got["spp_done"] == ref["spp_done"] == 2
    _films_match(np.asarray(ref[layer]), got[layer])


@pytest.fixture(scope="module")
def box_films():
    """{integrator: (scan film, wavefront film)}, box filter, 2 spp, 100 lanes."""
    out = {}
    for integ in wf.WAVEFRONT_INTEGRATORS:
        scene, config = _cornell(integ, "box")
        scan = render(scene, config, sample_count=2, device="cpu", mega=False)
        wave = wf.render_wavefront(scene, config, sample_count=2, n_lanes=100, sync_every=2,
                                   device="cpu")
        out[integ] = scan, wave
    return out


@pytest.mark.parametrize("integrator", wf.WAVEFRONT_INTEGRATORS)
def test_wavefront_box_film_bit_equal_to_scan(box_films, integrator):
    scan, wave = box_films[integrator]
    assert wave["spp_done"] == 2
    for layer in LAYERS:
        assert np.array_equal(wave[layer], scan[layer]), layer
    assert np.all(scan["weights"] == 2.0)


def test_wavefront_gaussian_film_matches_scan():
    scene, config = _cornell("path_mis", "gaussian")
    scan = render(scene, config, sample_count=2, device="cpu", mega=False)
    wave = wf.render_wavefront(scene, config, sample_count=2, n_lanes=100, sync_every=2,
                               device="cpu")
    for layer in LAYERS:
        np.testing.assert_allclose(wave[layer], scan[layer], rtol=2e-4, atol=2e-5)


def test_lane_pool_larger_than_work(box_films, monkeypatch):
    """n_lanes > the work: the pool is clamped to it; the film is (b)'s."""
    sizes = []
    init = wf.init_state

    def spy(n, *a, **k):
        sizes.append(n)
        return init(n, *a, **k)

    monkeypatch.setattr(wf, "init_state", spy)
    scene, config = _cornell("path_mis", "box")
    out = wf.render_wavefront(scene, config, sample_count=2, n_lanes=1 << 19, device="cpu")
    assert sizes == [24 * 16 * 2]
    for layer in LAYERS:
        assert np.array_equal(out[layer], box_films["path_mis"][1][layer]), layer


@pytest.mark.parametrize("integrator,per_iter", [("path_mis", 2), ("path_mats", 1)])
def test_intersections_per_iteration(monkeypatch, integrator, per_iter):
    """Every iteration traces the whole pool once (and path_mis its shadow
    rays once): the wrapper's calls are exactly per_iter per iteration,
    and the host reads the counters every sync_every iterations."""
    calls = {"iter": 0, "brute": 0}
    it, brute = wf.wavefront_iter, isect.isect_brute

    def count_iter(*a, **k):
        calls["iter"] += 1
        return it(*a, **k)

    def count_brute(*a, **k):
        calls["brute"] += 1
        return brute(*a, **k)

    monkeypatch.setattr(wf, "wavefront_iter", count_iter)
    monkeypatch.setattr(isect, "isect_brute", count_brute)
    scene, config = _cornell(integrator, "box", depth=4)
    out = wf.render_wavefront(scene, config, sample_count=1, n_lanes=64, sync_every=3,
                              device="cpu")
    assert out["spp_done"] == 1
    assert calls["iter"] > 0 and calls["iter"] % 3 == 0
    assert calls["brute"] == per_iter * calls["iter"]


def test_render_dispatches_to_wavefront(monkeypatch, capsys):
    """render(wavefront=True) takes path regeneration even for a scene the
    path kernel takes; the default does not; another integrator keeps the
    scan path; checkpoints refuse it; a CUDA request without a GPU raises."""
    called = []
    orig = wf.render_wavefront

    def spy(*a, **k):
        called.append(k)
        return orig(*a, **k)

    def no_kernel(*a, **k):
        raise AssertionError("the path kernel ran under wavefront=True")

    monkeypatch.setattr(wf, "render_wavefront", spy)
    scene, config = _cornell("path_mis", depth=3)
    assert pathk_eligible(scene, config)
    with monkeypatch.context() as m:
        m.setattr(mega_render, "mega_step", no_kernel)
        out = render(scene, config, sample_count=1, device="cpu", wavefront=True, verbose=True,
                     preview_every=2, preview_callback=lambda layers, spp: None)
    assert len(called) == 1 and called[0]["preview_every_iters"] == 8
    assert out["spp_done"] == 1 and np.isfinite(out["composite"]).all()
    assert "wavefront iter" in capsys.readouterr().out

    # the default is the path kernel (the scan path with mega=False)
    called.clear()
    render(scene, config, sample_count=1, device="cpu")
    render(scene, config, sample_count=1, device="cpu", mega=False, wavefront=False)
    assert not called

    # an integrator without a wavefront body keeps the scan path
    direct = dataclasses.replace(config, integrator="direct_mis")
    a = render(scene, direct, sample_count=1, device="cpu", wavefront=True)
    b = render(scene, direct, sample_count=1, device="cpu")
    assert not called
    for layer in LAYERS:
        assert np.array_equal(a[layer], b[layer])

    for kw in ({"checkpoint_path": "unused.npz"}, {"resume": True}):
        with pytest.raises(ValueError, match="checkpoint"):
            render(scene, config, sample_count=1, device="cpu", wavefront=True, **kw)
    with pytest.raises(ValueError):
        orig(scene, direct, sample_count=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        render(scene, config, sample_count=1, device="cuda", wavefront=True)


def _splat_inputs(n=500, h=12, w=16, seed=15):
    r = np.random.default_rng(seed)
    pos = r.uniform(-1.0, [w + 1.0, h + 1.0], (n, 2)).astype(np.float32)
    layers = r.normal(size=(3, n, 3)).astype(np.float32)
    mask = r.uniform(size=n) < 0.3
    return pos, layers, mask


@pytest.mark.parametrize("rfilter", ["box", "gaussian", "mitchell"])
def test_masked_splat_equals_subset(rfilter):
    """A masked lane adds nothing: the film equals that of the unmasked
    lanes alone, bit for bit; mask=None equals an all-True mask; the JAX
    `film.splat` with the same mask agrees to rounding."""
    pos, layers, mask = _splat_inputs()
    tp, tl, tm = torch.from_numpy(pos), torch.from_numpy(layers), torch.from_numpy(mask)
    masked = torch.zeros((3, 12, 16, 4))
    film.splat_(masked, rfilter, tp, tl, mask=tm)
    subset = torch.zeros((3, 12, 16, 4))
    film.splat_(subset, rfilter, tp[tm], tl[:, tm])
    assert torch.equal(masked, subset)
    assert masked[0, ..., 3].sum() > 0

    plain = film.splat(16, 12, rfilter, tp, tl)
    ones = torch.zeros((3, 12, 16, 4))
    film.splat_(ones, rfilter, tp, tl, mask=torch.ones(500, dtype=torch.bool))
    assert torch.equal(plain, ones)

    ref = jfilm.splat(16, 12, rfilter, jnp.asarray(pos), jnp.asarray(layers),
                      mask=jnp.asarray(mask))
    np.testing.assert_allclose(masked.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_splat_without_mask_keeps_its_gradient():
    """mask=None leaves `splat` differentiable as before: d(sum film)/d layers
    is each lane's in-image filter weight sum, on every lane."""
    pos, layers, _ = _splat_inputs(n=64)
    tl = torch.from_numpy(layers).requires_grad_(True)
    img = film.splat(16, 12, "tent", torch.from_numpy(pos), tl)
    img[..., :3].sum().backward()
    wsum = film.splat(16, 12, "tent", torch.from_numpy(pos), torch.ones_like(tl))[0, ..., 3]
    assert torch.allclose(tl.grad.sum(), 9.0 * wsum.sum())
    assert tl.grad.shape == tl.shape


def test_box_sample_at_a_pixel_edge_lands_in_the_next_pixel():
    """pixel + jitter is a float32 sum: at x = 511 a jitter within an ulp
    of 1 rounds it to 512, the next pixel's edge, and the box filter puts
    the sample there, in both packages. Such a pixel adds three samples at
    2 spp, in an order that differs between the scan path and the
    wavefront, so the two films part in its last bits."""
    jitter = np.float32(np.nextafter(np.float32(1.0), np.float32(0.0)))
    pos = torch.tensor([[511.0, 3.0]]) + torch.tensor([[jitter, 0.5]])
    assert float(pos[0, 0]) == 512.0
    img = torch.zeros((3, 8, 600, 4))
    film.splat_(img, "box", pos, torch.ones((3, 1, 3)))
    assert torch.nonzero(img[0, ..., 3]).tolist() == [[3, 512]]
    ref = jfilm.splat(600, 8, "box", jnp.asarray(pos.numpy()), jnp.ones((3, 1, 3)))
    assert np.argwhere(np.asarray(ref)[0, ..., 3]).tolist() == [[3, 512]]
