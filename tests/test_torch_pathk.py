"""The port's path kernel (its plain torch version, which is what runs on the
CPU) against the JAX path kernel in interpret mode, on the same scenes.

Statistic (tests/test_mega.py:203-211): Russian roulette flips on
floating-point association, so films are compared per pixel by the median
of |a−b|/(|a|+1e-3) < 1e-3 and means within 10 %; first-hit albedo agrees to
atol 2e-3 and sample counts exactly. Row 10 is not compared: the port counts
iterations per pixel, the TPU kernel per 4096-pixel block.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.ops.pallas import pathk as jpathk
from optix_renderer_tpu.render.mega_render import render_mega
from optix_renderer_tpu.scene import build as jbuild
from optix_renderer_tpu.scene import presets as jpresets
from optix_renderer_tpu_torch.ops.cuda import pathk
from optix_renderer_tpu_torch.render.render import render
from optix_renderer_tpu_torch.scene import build, presets
from optix_renderer_tpu_torch.utils.imageio import read_exr
from test_torch_scene import LIGHTS, room_xml

pytestmark = pytest.mark.heavy

GOLDEN = __import__("pathlib").Path(__file__).resolve().parent / "golden"


def _assert_films_match(a, b):
    rel = np.abs(a - b) / (np.abs(a) + 1e-3)
    assert np.median(rel) < 1e-3, np.median(rel)
    assert np.mean(b) == pytest.approx(np.mean(a), rel=0.1)


def _cornell(integrator, w=24, h=16, rfilter="box", depth=3):
    js, jc, _ = jpresets.make_cornell_box(width=w, height=h, spp=1, integrator=integrator)
    ts, tc, _ = presets.make_cornell_box(width=w, height=h, spp=1, integrator=integrator,
                                         device="cpu")
    return (js, dataclasses.replace(jc, max_depth=depth, rfilter=rfilter),
            ts, dataclasses.replace(tc, max_depth=depth, rfilter=rfilter))


def test_raw_rows_match_jax_kernel():
    js, jc, ts, tc = _cornell("path_mis")
    n_pix = tc.width * tc.height
    jt, jm = jpathk.build_pathk_tables(js, jc)
    ref = jax.jit(lambda: jpathk.pathk_trace(jt, jm, jc, n_pix=n_pix, nb=1, spp0=0, n_spp=2,
                                             interpret=True))()
    ref = np.asarray(ref).reshape(16, -1)[:, :n_pix]
    tt, tm = pathk.build_pathk_tables(ts, tc)
    got = pathk.pathk_trace(tt, tm, tc, n_pix=n_pix, spp0=0, n_spp=2).numpy()
    assert got.shape == (16, n_pix)
    np.testing.assert_array_equal(got[3], ref[3])
    assert np.all(got[3] == 2.0)
    _assert_films_match(ref[0:3], got[0:3])
    np.testing.assert_allclose(got[4:7] / 2, ref[4:7] / 2, atol=2e-3)
    np.testing.assert_allclose(got[7:10] / 2, ref[7:10] / 2, atol=2e-3)
    # per-pixel iteration counts never exceed the block's count or the cap
    assert np.all((got[10] >= 1) & (got[10] <= ref[10].max()) & (got[10] <= 2 * 3 + 2))
    assert np.all(got[11:] == 0)


@pytest.mark.parametrize("rfilter,lens", [("gaussian", False), ("tent", False),
                                          ("gaussian", True)])
def test_raw_rows_match_jax_kernel_filters_and_lens(rfilter, lens):
    """The raw rows with the filters the kernel importance-samples beside
    the box, and with a thin lens (radius 0.1, focal distance 3), at
    pix0 = 0: sample counts equal, the radiance rows by the median of
    |a−b|/(|a|+1e-3) < 1e-6 (measured ~1.1e-7 to 1.3e-7: the two differ
    only by float association), first-hit albedo and normal to atol 2e-3
    per sample."""
    js, jc, ts, tc = _cornell("path_mis", rfilter=rfilter)
    if lens:
        js = js._replace(camera=js.camera._replace(lens_radius=jnp.float32(0.1),
                                                   focal_distance=jnp.float32(3.0)))
        ts = dataclasses.replace(ts, camera=dataclasses.replace(
            ts.camera, lens_radius=torch.tensor(0.1), focal_distance=torch.tensor(3.0)))
    n_pix = tc.width * tc.height
    jt, jm = jpathk.build_pathk_tables(js, jc)
    ref = jax.jit(lambda: jpathk.pathk_trace(jt, jm, jc, n_pix=n_pix, nb=1, spp0=0, n_spp=2,
                                             interpret=True))()
    ref = np.asarray(ref).reshape(16, -1)[:, :n_pix]
    tt, tm = pathk.build_pathk_tables(ts, tc)
    assert tm["use_dof"] == jm["use_dof"] == lens
    got = pathk.pathk_trace(tt, tm, tc, n_pix=n_pix, spp0=0, n_spp=2, pix0=0).numpy()
    np.testing.assert_array_equal(got[3], ref[3])
    rel = np.abs(got[0:3] - ref[0:3]) / (np.abs(ref[0:3]) + 1e-3)
    assert np.median(rel) < 1e-6, np.median(rel)
    np.testing.assert_allclose(got[4:10] / 2, ref[4:10] / 2, atol=2e-3)


@pytest.mark.parametrize("integrator", ["path_mis", "path_mats"])
def test_cornell_film_matches_jax_kernel(integrator):
    js, jc, ts, tc = _cornell(integrator)
    ref = render_mega(js, jc, sample_count=2, interpret=True)
    got = render(ts, tc, sample_count=2, device="cpu")
    _assert_films_match(ref["composite"], got["composite"])
    np.testing.assert_allclose(got["albedo"], ref["albedo"], atol=2e-3)
    assert np.all(got["weights"] == 2.0)  # sample counts, not filter weights
    assert got["spp_done"] == 2


def test_spot_room_film_matches_jax_kernel(tmp_path):
    xml = room_xml(tmp_path, LIGHTS["spot"])
    js, jc, _ = jbuild.load_scene(xml)
    ts, tc, _ = build.load_scene(xml, device="cpu")
    jc = dataclasses.replace(jc, max_depth=3, rfilter="box")
    tc = dataclasses.replace(tc, max_depth=3, rfilter="box")
    ref = render_mega(js, jc, sample_count=4, interpret=True)
    got = render(ts, tc, sample_count=4, device="cpu")
    assert ref["composite"].max() > 0.005
    _assert_films_match(ref["composite"], got["composite"])
    np.testing.assert_allclose(got["albedo"], ref["albedo"], atol=2e-3)


@pytest.mark.parametrize("integrator,block", [("path_mis", 1), ("path_mats", 4)])
def test_golden_plain_version(integrator, block):
    """The golden config (tools/gen_golden.py:33-37): means within 5 % and
    mean |a−b|/(|a|+0.05) < 0.35 (tests/test_mega.py:230-232). The goldens
    are splatted films and the kernel's is filter-importance sampled;
    path_mats at 8 spp misses the per-pixel bound for the JAX path kernel
    as well (next test), so it is checked on 4×4-pixel block means."""
    ts, tc, _ = presets.make_cornell_box(64, 48, 1, integrator, device="cpu")
    tc = dataclasses.replace(tc, max_depth=4, rfilter="gaussian")
    b = render(ts, tc, sample_count=8, device="cpu")["composite"]
    a = read_exr(GOLDEN / f"cbox_{integrator}.exr")[..., :3]
    assert b.mean() == pytest.approx(a.mean(), rel=0.05)
    ab, bb = (x.reshape(48 // block, block, 64 // block, block, 3).mean((1, 3)) for x in (a, b))
    assert np.mean(np.abs(ab - bb) / (np.abs(ab) + 0.05)) < 0.35


def test_golden_per_pixel_statistic_of_jax_kernel():
    """Why path_mats is held to the golden on block means: at the golden
    config the JAX path kernel's own film misses the per-pixel bound
    (0.6655 against 0.35), and the plain version gives the same film."""
    ts, tc, _ = presets.make_cornell_box(64, 48, 1, "path_mats", device="cpu")
    js, jc, _ = jpresets.make_cornell_box(width=64, height=48, spp=1, integrator="path_mats")
    tc = dataclasses.replace(tc, max_depth=4, rfilter="gaussian")
    jc = dataclasses.replace(jc, max_depth=4, rfilter="gaussian")
    a = read_exr(GOLDEN / "cbox_path_mats.exr")[..., :3]
    j = render_mega(js, jc, sample_count=8, interpret=True)["composite"]
    b = render(ts, tc, sample_count=8, device="cpu")["composite"]
    _assert_films_match(j, b)
    err_j, err_b = (np.mean(np.abs(a - x) / (np.abs(a) + 0.05)) for x in (j, b))
    assert err_j > 0.35, err_j
    assert err_b == pytest.approx(err_j, abs=1e-3)


def test_checkpoint_resume_equals_unbroken_render(tmp_path):
    ts, tc, _ = presets.make_cornell_box(24, 16, 1, "path_mis", device="cpu")
    tc = dataclasses.replace(tc, max_depth=3, rfilter="gaussian")
    full = render(ts, tc, sample_count=4, device="cpu")
    ckpt = str(tmp_path / "film")
    part = render(ts, tc, sample_count=2, device="cpu", checkpoint_path=ckpt)
    assert part["spp_done"] == 2
    resumed = render(ts, tc, sample_count=4, device="cpu", checkpoint_path=ckpt, resume=True)
    assert resumed["spp_done"] == 4
    for k in ("composite", "albedo", "normal", "weights"):
        np.testing.assert_allclose(resumed[k], full[k], rtol=1e-5, atol=1e-5)


def test_preview_and_checkpoint_cadence(tmp_path):
    """Previews every 3 and checkpoints every 2 samples: with `%` cadence
    previews would only fire on multiples of the group size; here every
    period of at least `every` samples yields one."""
    ts, tc, _ = presets.make_cornell_box(8, 6, 1, "path_mats", device="cpu")
    tc = dataclasses.replace(tc, max_depth=2)
    seen = []
    render(ts, tc, sample_count=7, device="cpu", preview_every=3,
           preview_callback=lambda layers, spp: seen.append(spp),
           checkpoint_path=str(tmp_path / "c.npz"), checkpoint_every=2)
    assert seen == [4, 7]  # groups of 2 samples: 2, 4, 6, 7
