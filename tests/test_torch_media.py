"""The port's media modules against the JAX package's, on the CPU.

Same numpy-seeded inputs through both packages, small sizes (≤ 4,096
lanes, grids of 16³ or less), a scene with every kind of medium and phase
function (`media_zoo`, built by the JAX builder and carried across):

* the phase and volume warps (`core/warp.py`) and every function of
  `ops/medium.py`, 1e-5 relative (5e-6 absolute);
* `density_at` / `temperature_at`, 1e-6;
* the lockstep trackers `delta_track_ref` / `ratio_track_ref` against the
  JAX trackers: every lane's pcg32 state after the call equal (so L, the
  loop's iteration count, is the same), t_event / T within 1e-5 on at
  least 99.9 % of the active lanes, and every other lane explained by a
  real / null decision within 1e-5 of its uniform (the check-the-cause
  pattern of tests/test_torch_general.py);
* `track_design_ref`, the tracking kernel's walk-then-jump-ahead
  decomposition, bit-equal to the lockstep versions, and
  `rng.pcg32_advance(s, n)` equal to n single steps;
* the constant-density trackers against the analytic exponential
  statistics (tests/test_heterog.py:103-135);
* the volume-emitter sampler against the JAX one and against quadrature
  (tests/test_volumelight.py:62-135);
* the `.vdb` reader's LZ4 / blosc unit cases (tests/test_vdb.py:116-129).
"""

import struct

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.core import warp as jwarp
from optix_renderer_tpu.ops import emitter as jemitter
from optix_renderer_tpu.ops import medium as jmedium
from optix_renderer_tpu.ops import volume_grid as jvg
from optix_renderer_tpu.render import sampler as jsmp
from optix_renderer_tpu.scene import build as jbuild
from optix_renderer_tpu_torch.core import rng, warp
from optix_renderer_tpu_torch.ops import emitter, medium
from optix_renderer_tpu_torch.ops import volume_grid as vg
from optix_renderer_tpu_torch.ops.cuda import track
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.scene import vdb
from optix_renderer_tpu_torch.scene.data import EmitterType, scene_from_numpy

N = 4096
CUBE_OBJ = (
    "v -0.5 -0.5 -0.5\nv 0.5 -0.5 -0.5\nv 0.5 0.5 -0.5\nv -0.5 0.5 -0.5\n"
    "v -0.5 -0.5 0.5\nv 0.5 -0.5 0.5\nv 0.5 0.5 0.5\nv -0.5 0.5 0.5\n"
    "f 1 3 2\nf 1 4 3\nf 5 6 7\nf 5 7 8\nf 1 6 5\nf 1 2 6\n"
    "f 2 7 6\nf 2 3 7\nf 3 8 7\nf 3 4 8\nf 4 5 8\nf 4 1 5\n"
)


def media_zoo_xml(tmp_path, density=None) -> str:
    """Every medium and phase function of the builder in one scene: three
    homogeneous spheres (isotropic, Henyey–Greenstein, Schlick; one with an
    exterior vacuum), a heterogeneous cube from a 12×10×8 `.npz` grid with
    a temperature grid, an absorbing sphere and a cube holding volume
    lights (ball and bbox sampling), and an ambient medium."""
    rng_np = np.random.default_rng(5)
    if density is None:
        density = rng_np.uniform(0.0, 2.0, (12, 10, 8)).astype(np.float32)
    np.savez(tmp_path / "grid.npz", density=density,
             temperature=rng_np.uniform(0.2, 1.0, density.shape).astype(np.float32),
             bbox_min=np.array([-0.5, -0.5, -0.5], np.float32),
             bbox_max=np.array([0.5, 0.5, 0.5], np.float32))
    (tmp_path / "cube.obj").write_text(CUBE_OBJ)
    (tmp_path / "cube2.obj").write_text(CUBE_OBJ.replace("v -0.5", "v 1.5").replace(
        "v 0.5", "v 2.5"))
    xml = """<scene><integrator type="path_vol_mis"/>
<camera type="perspective"><integer name="width" value="16"/><integer name="height" value="12"/>
<transform name="toWorld"><lookat origin="0 -3 0.5" target="0 0 0" up="0 0 1"/></transform>
</camera>
<shape type="sphere"><point name="center" value="-1.5 0 0"/><float name="radius" value="0.4"/>
<medium type="homog"><color name="sigma_a" value="0.2 0.3 0.4"/><color name="sigma_s" value="0.5 0.1 0.9"/>
<float name="density" value="2"/><phase type="isophase"/></medium></shape>
<shape type="sphere"><point name="center" value="-1.5 1 0"/><float name="radius" value="0.3"/>
<medium type="homog"><color name="sigma_a" value="0.1 0.1 0.1"/><color name="sigma_s" value="1 2 3"/>
<float name="sigma_a_intensity" value="2"/><phase type="anisophase"><float name="g" value="0.6"/></phase>
</medium></shape>
<shape type="sphere"><point name="center" value="-1.5 -1 0"/><float name="radius" value="0.3"/>
<bsdf type="diffuse"/>
<medium type="homog" name="interior"><color name="sigma_s" value="2 1 0.5"/>
<phase type="schlick"><float name="g" value="-0.3"/></phase></medium>
<medium type="vacuum" name="exterior"/></shape>
<shape type="obj"><string name="filename" value="cube.obj"/>
<medium type="heterog"><color name="sigma_a" value="1.5 1.0 0.5"/><color name="sigma_s" value="2.5 2 1"/>
<float name="densityScale" value="1.5"/><float name="temperatureScale" value="3"/>
<volume type="volume"><string name="filename" value="grid.npz"/></volume></medium></shape>
<shape type="sphere"><point name="center" value="0 1.2 0.3"/><float name="radius" value="0.25"/>
<medium type="homog"><color name="sigma_a" value="0.5 0.5 0.5"/><color name="sigma_s" value="0 0 0"/>
<emitter type="volumelight"><color name="radiance" value="2 2 2"/></emitter></medium></shape>
<shape type="obj"><string name="filename" value="cube2.obj"/>
<medium type="homog"><color name="sigma_a" value="1 1 1"/>
<emitter type="volumelight"><color name="radiance" value="0.5 1 1.5"/></emitter></medium></shape>
<emitter type="point"><point name="position" value="0 0 3"/><color name="power" value="50 50 50"/></emitter>
<medium type="homog"><color name="sigma_a" value="0.01 0.01 0.01"/><color name="sigma_s" value="0.05 0.05 0.05"/></medium>
</scene>"""
    path = tmp_path / "zoo.xml"
    path.write_text(xml)
    return str(path)


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    js, jc, _ = jbuild.load_scene(media_zoo_xml(tmp_path_factory.mktemp("zoo")))
    return js, jc, scene_from_numpy(jax.tree.map(np.asarray, js))


def _close(got, ref, rtol=1e-5, atol=5e-6, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


def _lanes(js, n=N, seed=3):
    """Medium ids over every row and −1, points in and around the grid's
    box, unit directions, distances, and uniforms."""
    r = np.random.default_rng(seed)
    n_med = np.asarray(js.media.type).shape[0]
    med = r.integers(-1, n_med, n).astype(np.int32)
    p = r.uniform(-0.7, 0.7, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return dict(med=med, p=p, d=d, t=r.uniform(0.0, 3.0, n).astype(np.float32),
                u=r.uniform(size=(n, 3)).astype(np.float32))


def _samplers(n, sample=3):
    pix = np.arange(n, dtype=np.int64)
    return (jsmp.make_sampler(jnp.asarray(pix, jnp.int32).astype(jnp.uint32), jnp.uint32(sample)),
            smp.make_sampler(torch.from_numpy(pix), sample))


def _same_state(ts, js):
    """Every lane's pcg32 state words equal."""
    for k in range(4):
        np.testing.assert_array_equal(ts.state[k].numpy(), np.asarray(js.state[k]).astype(np.int64))


@pytest.mark.parametrize("g", [0.0, 0.6, -0.45])
def test_phase_and_volume_warps_match_jax(g):
    u = np.random.default_rng(1).uniform(size=(N, 3)).astype(np.float32)
    gj, gt = jnp.full(N, g, jnp.float32), torch.full((N,), g)
    for name in ("square_to_henyey_greenstein", "square_to_schlick"):
        got = getattr(warp, name)(torch.from_numpy(u[:, :2]), gt)
        ref = getattr(jwarp, name)(jnp.asarray(u[:, :2]), gj)
        _close(got, ref, what=name)
        _close(getattr(warp, name + "_pdf")(got, gt), getattr(jwarp, name + "_pdf")(ref, gj),
               what=name + "_pdf")
    got = warp.square_to_uniform_sphere_volume(torch.from_numpy(u))
    ref = jwarp.square_to_uniform_sphere_volume(jnp.asarray(u))
    _close(got, ref, what="sphere volume")
    _close(warp.square_to_uniform_sphere_volume_pdf(got),
           jwarp.square_to_uniform_sphere_volume_pdf(ref))


def test_medium_functions_match_jax(zoo):
    js, _, ts = zoo
    ln = _lanes(js)
    jm, tm = js.media, ts.media
    med_j, med_t = jnp.asarray(ln["med"]), torch.from_numpy(ln["med"])
    u, t = ln["u"], ln["t"]
    _close(medium.mu_t(tm, med_t), jmedium.mu_t(jm, med_j), what="mu_t")
    tf_t = medium.sample_free_path(tm, med_t, torch.from_numpy(u[:, 0]), torch.from_numpy(u[:, 1]))
    tf_j = jmedium.sample_free_path(jm, med_j, jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1]))
    _close(tf_t, tf_j, what="sample_free_path")
    _close(medium.transmittance(tm, med_t, torch.from_numpy(t)),
           jmedium.transmittance(jm, med_j, jnp.asarray(t)), what="transmittance")
    got = medium.free_path_weights(tm, med_t, tf_t, torch.from_numpy(t))
    ref = jmedium.free_path_weights(jm, med_j, tf_j, jnp.asarray(t))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for k in (1, 2):
        _close(got[k], ref[k], what=f"free_path_weights {k}")
    wo_t = medium.phase_sample(tm, med_t, torch.from_numpy(u[:, :2]))
    wo_j = jmedium.phase_sample(jm, med_j, jnp.asarray(u[:, :2]))
    _close(wo_t, wo_j, what="phase_sample")
    _close(medium.phase_pdf(tm, med_t, wo_t), jmedium.phase_pdf(jm, med_j, wo_j), what="phase_pdf")
    v, scale = torch.from_numpy(u[:, 0]), torch.from_numpy(u[:, 1] * 4)
    _close(medium.color_from_temperature(v, scale),
           jmedium.color_from_temperature(jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1] * 4)))
    _close(medium.event_emission(tm, med_t, torch.from_numpy(ln["p"])),
           jmedium.event_emission(jm, med_j, jnp.asarray(ln["p"])), what="event_emission")
    assert np.asarray(jmedium.event_emission(jm, med_j, jnp.asarray(ln["p"]))).max() > 0


def test_grid_lookups_match_jax(zoo):
    js, _, ts = zoo
    ln = _lanes(js)
    med_j, med_t = jnp.asarray(ln["med"]), torch.from_numpy(ln["med"])
    p_j, p_t = jnp.asarray(ln["p"]), torch.from_numpy(ln["p"])
    for name in ("density_at", "temperature_at"):
        got = getattr(vg, name)(ts.media, med_t, p_t)
        ref = getattr(jvg, name)(js.media, med_j, p_j)
        _close(got, ref, rtol=0.0, atol=1e-6, what=name)
        assert float(np.asarray(ref).max()) > 0.1
    # the grid's bbox: inside the cube, zero outside (one voxel of padding)
    het = int(np.nonzero(np.asarray(js.media.type) == 2)[0][0])
    far = torch.full((8, 3), 0.6)
    assert (vg.density_at(ts.media, torch.full((8,), het, dtype=torch.int32), far) == 0).all()


def _tracker_inputs(js, n=N, seed=4):
    """Rays from around the heterogeneous cube through it (every lane in its
    medium except one in eight, which sits in another medium or none)."""
    r = np.random.default_rng(seed)
    het = int(np.nonzero(np.asarray(js.media.type) == 2)[0][0])
    med = np.full(n, het, np.int32)
    other = r.uniform(size=n) < 0.125
    med[other] = r.integers(-1, het, other.sum())
    o = r.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    target = r.uniform(-0.4, 0.4, (n, 3))
    d = target - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_max = np.where(r.uniform(size=n) < 0.5, np.inf, r.uniform(0.5, 3.0, n)).astype(np.float32)
    return med, o, d, t_max


def _explained(ts, med, o, d, t_max, lanes, ratio):
    """Replay each lane of `lanes` with the port's own draws and return the
    smallest relative gap of any decision on its walk: escape (t_new
    against the segment's end), real / null (μ/M against u2, delta
    tracking) and the T ≤ 1e-6 cut (ratio tracking)."""
    sl = torch.from_numpy(np.asarray(lanes, np.int64))
    m = ts.media
    med_t = torch.from_numpy(med)[sl]
    o_t, d_t, tm_t = (torch.from_numpy(x)[sl] for x in (o, d, t_max))
    st = smp.make_sampler(sl, 3).state
    t, t1, M, st_max, active = vg._setup(m, med_t, o_t, d_t, tm_t)
    tr = torch.ones(len(lanes))
    best = torch.full((len(lanes),), float("inf"))
    for _ in range(vg.MAX_TRACK_STEPS):
        if not bool(active.any()):
            break
        st, t_new, escaped, mu, u2 = vg._step(m, med_t, st, t, o_t, d_t, t1, M, st_max, ratio)
        gap = (t_new - t1).abs() / t1.abs().clamp(min=1e-30)
        inside = active & ~escaped
        if ratio:
            tr = torch.where(inside, tr * torch.clamp(1.0 - mu, min=0.0), tr)
            gap = torch.where(inside, torch.minimum(gap, (tr - 1e-6).abs() / 1e-6), gap)
            active = inside & (tr > 1e-6)
        else:
            gap = torch.where(inside, torch.minimum(gap, (mu - u2).abs()), gap)
            active = inside & ~(mu >= u2)
        best = torch.minimum(best, torch.where(active | inside, gap, float("inf")))
        t = torch.where(active, t_new, t)
    return best.numpy()


@pytest.mark.parametrize("ratio", [False, True])
def test_lockstep_trackers_match_jax(zoo, ratio):
    js, _, ts = zoo
    med, o, d, t_max = _tracker_inputs(js)
    jsamp, tsamp = _samplers(N)
    args_j = (js.media, jnp.asarray(med), jsamp, jnp.asarray(o), jnp.asarray(d),
              jnp.asarray(t_max))
    args_t = (ts.media, torch.from_numpy(med), tsamp, torch.from_numpy(o), torch.from_numpy(d),
              torch.from_numpy(t_max))
    if ratio:
        js2, ref = jvg.ratio_track(*args_j)
        ref = np.asarray(ref)[:, 0]
        ts2, got, k = vg.ratio_track_ref(*args_t)
    else:
        js2, ref, _ = jvg.delta_track(*args_j)
        ref = np.asarray(ref)
        ts2, got, k = vg.delta_track_ref(*args_t)
    got = got.numpy()
    # the states moved by the same number of lockstep iterations
    _same_state(ts2, js2)
    active = vg._setup(ts.media, args_t[1], *args_t[3:])[-1].numpy()
    assert active.mean() > 0.5 and k.numpy().sum() > N
    same = got == ref  # +inf on both sides included
    with np.errstate(invalid="ignore"):
        off = ~same & ~(np.abs(got - ref) <= 1e-5 * np.abs(ref) + 1e-7)
    assert not (off & ~active).any()
    assert off[active].mean() <= 1e-3, off.sum()
    if off.any():
        gaps = _explained(ts, med, o, d, t_max, np.nonzero(off)[0], ratio)
        assert (gaps <= 1e-5).all(), gaps


@pytest.mark.parametrize("ratio", [False, True])
def test_design_ref_equals_lockstep(zoo, ratio):
    """The kernel's decomposition (each lane walked alone, then pcg32
    jump-ahead by the lockstep iteration count) is bit-equal to the
    lockstep loop: outputs, K and all four state words."""
    js, _, ts = zoo
    med, o, d, t_max = _tracker_inputs(js, seed=9)
    _, tsamp = _samplers(N, sample=7)
    args = (ts.media, torch.from_numpy(med), tsamp, torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(t_max))
    s_ref, out_ref, k_ref = (vg.ratio_track_ref if ratio else vg.delta_track_ref)(*args)
    s_des, out_des, k_des, steps = vg.track_design_ref(*args, ratio=ratio)
    assert steps > 3
    assert torch.equal(out_ref, out_des) and torch.equal(k_ref, k_des)
    for a, b in zip(s_ref.state, s_des.state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [0, 1, 2, 5, 64, 999])
def test_pcg32_advance_equals_single_steps(n):
    s = smp.make_sampler(torch.arange(16), 2).state
    want = s
    for _ in range(n):
        want = rng._pcg32_step(want)
    for a, b in zip(rng.pcg32_advance(s, n), want):
        assert torch.equal(a, b)


SIGMA_T = 4.0


@pytest.fixture(scope="module")
def const_grid(tmp_path_factory):
    """The zoo with a constant-density grid: σt = max_c(σa + σs)·1.5 on the
    cube, whose channel maximum is σt = 6."""
    tmp = tmp_path_factory.mktemp("const")
    js, _, _ = jbuild.load_scene(media_zoo_xml(tmp, np.ones((16, 16, 16), np.float32)))
    ts = scene_from_numpy(jax.tree.map(np.asarray, js))
    return ts, int(np.nonzero(np.asarray(js.media.type) == 2)[0][0])


def test_constant_grid_trackers_match_analytic(const_grid):
    """Delta tracking on a constant grid: escape probability exp(−σt·L) and
    the truncated exponential's mean; ratio tracking: mean T = exp(−σt·d),
    every estimate in [0, 1] (tests/test_heterog.py:103-135). σt = 6 here
    (the cube's channel maximum 4 × densityScale 1.5)."""
    ts, het = const_grid
    n, sig = 8192, 6.0
    med = torch.full((n,), het, dtype=torch.int32)
    s = smp.make_sampler(torch.arange(n), 3)
    ro = torch.tensor([0.0, -0.5, 0.0]).expand(n, 3).contiguous()
    rd = torch.tensor([0.0, 1.0, 0.0]).expand(n, 3).contiguous()
    _, t_event, _ = vg.delta_track(ts.media, med, s, ro, rd, torch.full((n,), 1.0))
    te = t_event.numpy()
    # within half a voxel (1/32) of a face the trilinear density ramps from
    # 0.5 to 1, which takes 1/128 off the optical depth per face
    assert abs(np.mean(~np.isfinite(te)) - np.exp(-sig * (1.0 - 1.0 / 64))) < 0.01
    col = te[np.isfinite(te)]
    assert abs(col.mean() - (1.0 / sig - np.exp(-sig) / (1 - np.exp(-sig)))) < 0.02
    _, tr = medium.transmittance_est(ts.media, med, smp.make_sampler(torch.arange(n), 9), ro,
                                     rd, torch.full((n,), 0.6))
    tr = tr[:, 0].numpy()
    want = np.exp(-sig * (0.6 - 1.0 / 128))
    assert abs(tr.mean() - want) / want < 0.05
    assert tr.min() >= 0.0 and tr.max() <= 1.0 + 1e-6


def test_sample_interaction_and_transmittance_est_match_jax(zoo):
    """The homogeneous / heterogeneous dispatch (delta tracking inside
    `sample_interaction`, ratio tracking inside `transmittance_est`) with
    the sampler draws of both packages in step."""
    js, _, ts = zoo
    med, o, d, t_max = _tracker_inputs(js, n=2048, seed=12)
    med = np.where(np.arange(2048) % 3 == 0, np.random.default_rng(2).integers(
        -1, int(np.asarray(js.media.type).shape[0]), 2048), med).astype(np.int32)
    jsamp, tsamp = _samplers(2048, sample=5)
    jargs = (js.media, jnp.asarray(med), jsamp, jnp.asarray(o), jnp.asarray(d))
    targs = (ts.media, torch.from_numpy(med), tsamp, torch.from_numpy(o), torch.from_numpy(d))
    ref = jmedium.sample_interaction(*jargs, jnp.asarray(t_max))
    got = medium.sample_interaction(*targs, torch.from_numpy(t_max))
    _same_state(got[0], ref[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    for k in range(2, 6):
        g, r = got[k].numpy(), np.asarray(ref[k])
        fin = np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        _close(g[fin], r[fin], what=f"sample_interaction {k}")
    ref = jmedium.transmittance_est(*jargs, jnp.asarray(t_max))
    got = medium.transmittance_est(*targs, torch.from_numpy(t_max))
    _same_state(got[0], ref[0])
    _close(got[1], ref[1], what="transmittance_est")


def test_volume_emitter_sampler_matches_jax(zoo):
    """Ball and bbox volume lights: the same points, pdfs (dist²/volume),
    values and shadow bounds as the JAX sampler, n = −wi; the ball's points
    are uniform (radial CDF) and the ball's estimate of ∫ε/dist² dV matches
    quadrature (tests/test_volumelight.py:62-135)."""
    js, _, ts = zoo
    types = np.asarray(js.emitters.type)
    vols = np.nonzero(types == EmitterType.VOLUME)[0]
    assert len(vols) == 2 and ts.emitters.volume_lights
    r = np.random.default_rng(3)
    n = 20000
    u3 = r.uniform(size=(n, 3)).astype(np.float32)
    em = np.where(np.arange(n) % 2 == 0, vols[0], vols[1]).astype(np.int32)
    em[::7] = 0  # the point light
    ref_p = np.tile(np.array([[0.0, -3.0, 0.5]], np.float32), (n, 1))
    got = emitter.sample_emitter(ts, torch.from_numpy(em), torch.from_numpy(ref_p),
                                 torch.from_numpy(u3))
    want = jemitter.sample_emitter(js, jnp.asarray(em), jnp.asarray(ref_p), jnp.asarray(u3))
    for f in ("wi", "p", "n", "pdf", "value", "shadow_maxt"):
        _close(getattr(got, f), getattr(want, f), what=f)
    _close(emitter.pdf_volume_emitter(ts, torch.from_numpy(em), torch.from_numpy(ref_p), got.p),
           jemitter.pdf_volume_emitter(js, jnp.asarray(em), jnp.asarray(ref_p), want.p))
    ball = (em == vols[0])
    c, rad = np.array([0.0, 1.2, 0.3]), 0.25
    dist = np.linalg.norm(got.p.numpy()[ball] - c, axis=-1)
    assert dist.max() <= rad + 1e-5
    for frac, q in ((0.5, 0.125), (0.7937, 0.5)):
        assert abs((dist < rad * frac).mean() - q) < 0.02
    # E[ε / p] over the ball = ∫ ε / |x − y|² dV (ε = 2)
    est = float(got.value.numpy()[ball, 0].mean())
    g = np.linspace(-rad, rad, 64)
    dz, dy, dx = np.meshgrid(g, g, g, indexing="ij")
    pts = np.stack([dx, dy, dz], -1).reshape(-1, 3)
    inside = (pts ** 2).sum(-1) <= rad * rad
    quad = 2.0 * (1.0 / ((pts[inside] + c - ref_p[0]) ** 2).sum(-1)).sum() * (g[1] - g[0]) ** 3
    assert abs(est - quad) / quad < 0.03, (est, quad)


def test_cuda_wrapper_refuses_cpu_tensors(zoo):
    """The kernel's wrapper takes CUDA tensors only; on the CPU the trackers
    run their plain versions (`delta_track` / `ratio_track` dispatch)."""
    _, _, ts = zoo
    n = 8
    state = smp.make_sampler(torch.arange(n), 0).state
    with pytest.raises(ValueError, match="cuda"):
        track.track(False, ts.media, torch.zeros(n, dtype=torch.int32), state,
                    torch.zeros(n, 3), torch.ones(n, 3), torch.ones(n))


def test_vdb_lz4_block_overlapping_matches():
    """LZ4 decode incl. overlapping matches (RLE-style), vs a hand encoding:
    literals "abcd", then a match of offset 2 and length 8."""
    src = bytes([0x44 | 0x04]) + b"abcd" + bytes([2, 0])
    assert vdb._lz4_block_decompress(src, 12) == b"abcd" + b"cdcdcdcd"


def test_vdb_blosc_memcpy_chunk():
    payload = bytes(range(64))
    hdr = bytes([2, 1, 0x2, 1]) + struct.pack("<III", 64, 64, 16 + 64)
    assert vdb._blosc_decompress(hdr + payload) == payload
