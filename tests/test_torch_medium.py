"""The path kernel's medium branch (65–8,192 triangles) of the port — its plain
torch version, which is what runs on the CPU — against the JAX kernel's MXU
branch in interpret mode, on the same scenes and inputs.

Statistic (tests/test_mega.py:203-211): median of |a−b|/(|a|+1e-3) < 1e-3,
means within 10 %, first-hit albedo to atol 2e-3 and sample counts (row 3)
exactly. The JAX branch picks its closest hit on the matmul form of t and the
port on the Möller–Trumbore t, so on near-ties the two may take another
triangle: films are compared by the median statistic, never for equality.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.ops.pallas import mega as jmega
from optix_renderer_tpu.ops.pallas import pathk as jpathk
from optix_renderer_tpu.render.mega_render import render_mega
from optix_renderer_tpu.scene import build as jbuild
from optix_renderer_tpu.scene import presets as jpresets
from optix_renderer_tpu_torch.ops.cuda import mega, pathk
from optix_renderer_tpu_torch.render.render import render
from optix_renderer_tpu_torch.scene import build, presets
from test_torch_scene import LIGHTS, room_xml

pytestmark = pytest.mark.heavy


def _assert_films_match(a, b):
    rel = np.abs(a - b) / (np.abs(a) + 1e-3)
    assert np.median(rel) < 1e-3, np.median(rel)
    assert np.mean(b) == pytest.approx(np.mean(a), rel=0.1)


def _tess300(integrator, w=24, h=16):
    """The tessellated Cornell box at nu=12, nv=7: 300 triangles, which the
    JAX kernel pads to 512 and sweeps in two 256-triangle chunks."""
    js, jc, _ = jpresets.make_tessellated_cornell(w, h, 1, integrator, nu=12, nv=7)
    ts, tc, _ = presets.make_tessellated_cornell(w, h, 1, integrator, nu=12, nv=7, device="cpu")
    assert tc.n_tris == 300
    fix = dict(max_depth=3, rfilter="box")
    return js, dataclasses.replace(jc, **fix), ts, dataclasses.replace(tc, **fix)


def test_raw_rows_match_jax_mxu_branch():
    js, jc, ts, tc = _tess300("path_mis")
    n_pix = tc.width * tc.height
    jt, jm = jpathk.build_pathk_tables(js, jc)
    assert jm["use_mxu"]
    ref = jax.jit(lambda: jpathk.pathk_trace(jt, jm, jc, n_pix=n_pix, nb=1, spp0=0, n_spp=2,
                                             interpret=True))()
    ref = np.asarray(ref).reshape(16, -1)[:, :n_pix]
    tt, tm = pathk.build_pathk_tables(ts, tc)
    assert tm["t_cnt"] > pathk.VPU_MAX_TRIS and tm["te_pad"] == 8 and tt["et"].shape[0] == 8
    got = pathk.pathk_trace(tt, tm, tc, n_pix=n_pix, spp0=0, n_spp=2).numpy()
    assert got.shape == (16, n_pix)
    np.testing.assert_array_equal(got[3], ref[3])
    assert np.all(got[3] == 2.0)
    _assert_films_match(ref[0:3], got[0:3])
    np.testing.assert_allclose(got[4:7] / 2, ref[4:7] / 2, atol=2e-3)
    np.testing.assert_allclose(got[7:10] / 2, ref[7:10] / 2, atol=2e-3)
    assert np.all((got[10] >= 1) & (got[10] <= ref[10].max()) & (got[10] <= 2 * 3 + 2))
    assert np.all(got[11:] == 0)


def test_render_matches_jax_mxu_branch_path_mats():
    js, jc, ts, tc = _tess300("path_mats")
    assert pathk.pathk_eligible(ts, tc) and jpathk.pathk_eligible(js, jc)
    ref = render_mega(js, jc, sample_count=2, interpret=True)
    got = render(ts, tc, sample_count=2, device="cpu")
    _assert_films_match(ref["composite"], got["composite"])
    np.testing.assert_allclose(got["albedo"], ref["albedo"], atol=2e-3)
    assert np.all(got["weights"] == 2.0)  # sample counts: the path kernel ran
    assert got["spp_done"] == 2


def _per_triangle_sweep(tri, t_cnt, o, d, mint, maxt, so, sd, s_maxt):
    """`pathk._isect`'s contract as one Möller–Trumbore test per triangle in
    index order (mesh.cpp:61-97), strict `<` against the running best."""
    where = mega.where
    best_t, best_u, best_v = maxt, torch.zeros_like(maxt), torch.zeros_like(maxt)
    best_j = torch.full_like(maxt, -1, dtype=torch.int64)
    occl = torch.zeros_like(maxt, dtype=torch.bool)

    def mt(v0, e1, e2, o, d):
        pv = (d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
              d[0] * e2[1] - d[1] * e2[0])
        det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2]
        det_ok = torch.abs(det) > 1e-12
        inv = 1.0 / where(det_ok, det, 1e-12)
        tv = (o[0] - v0[0], o[1] - v0[1], o[2] - v0[2])
        uu = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv
        qv = (tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
              tv[0] * e1[1] - tv[1] * e1[0])
        vv = (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]) * inv
        tt = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv
        return det_ok & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0), uu, vv, tt

    for j, row in enumerate(tri[:t_cnt].tolist()):
        v0, e1, e2 = row[0:3], row[3:6], row[6:9]
        ok, uu, vv, tt = mt(v0, e1, e2, o, d)
        better = ok & (tt >= mint) & (tt < best_t)
        best_t, best_u, best_v = where(better, tt, best_t), where(better, uu, best_u), \
            where(better, vv, best_v)
        best_j = where(better, j, best_j)
        ok2, _, _, tt2 = mt(v0, e1, e2, so, sd)
        occl = occl | (ok2 & (tt2 >= mega.EPS) & (tt2 < s_maxt))
    hit = best_j >= 0
    attrs = where(hit[:, None], tri[best_j.clamp(min=0)], 0.0)
    return best_t, best_u, best_v, hit, attrs, occl


def test_chunked_medium_sweep_equals_the_per_triangle_sweep(monkeypatch):
    """The plain sweep of both branches (chunked [N, chunk] tensors, here 16
    triangles a chunk) gives a per-triangle sweep in index order bit for
    bit: the same winner, t, u, v, attribute row and occlusion."""
    from optix_renderer_tpu_torch.ops.cuda import isect

    r = np.random.default_rng(9)
    n, t_cnt = 4096, 70
    tri = r.random((t_cnt, pathk.TR_COLS)).astype(np.float32)
    tri[:, 0:3] = r.uniform(-1, 1, (t_cnt, 3))
    tri[:, 3:9] = r.normal(0, 0.5, (t_cnt, 6))
    vec = lambda a: tuple(torch.from_numpy(np.ascontiguousarray(a[:, c])) for c in range(3))
    unit = lambda a: a / np.linalg.norm(a, axis=1, keepdims=True)
    o, so = (vec(r.uniform(-2, 2, (n, 3)).astype(np.float32)) for _ in range(2))
    d, sd = (vec(unit(r.normal(size=(n, 3))).astype(np.float32)) for _ in range(2))
    mint = torch.full((n,), 1e-4)
    maxt = torch.from_numpy(np.where(r.random(n) < 0.3, 1.5, 3.4e38).astype(np.float32))
    s_maxt = torch.from_numpy(r.uniform(0.5, 3.0, n).astype(np.float32))
    monkeypatch.setattr(isect, "_SWEEP_PAIRS", n * 16)
    args = (torch.from_numpy(tri), t_cnt, o, d, mint, maxt, so, sd, s_maxt)
    ref = _per_triangle_sweep(*args)
    got = pathk._isect(*args)
    assert 0.1 < float(ref[3].float().mean()) < 0.9 and 0.1 < float(ref[5].float().mean()) < 0.9
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _strip_obj(tmp_path, y=0.25):
    """The 66-triangle strip of tests/test_torch_scene.py, lifted to height y
    and wound to face up. On the floor it would be coplanar with the floor's
    two triangles, and there the two branches break the exact tie in t on
    different roundings (matmul vs Möller–Trumbore)."""
    verts = [(x, y, -1.0 + 0.1 * k) for k in range(34) for x in (-1.0, 1.0)]
    lines = [f"v {a} {b} {c}" for a, b, c in verts]
    lines += [f"f {2 * k + 1} {2 * k + 3} {2 * k + 4} {2 * k + 2}" for k in range(33)]
    (tmp_path / "strip.obj").write_text("\n".join(lines) + "\n")
    return '<shape type="obj"><string name="filename" value="strip.obj"/></shape>'


def test_strip_room_with_glass_sphere_and_spot_matches_jax(tmp_path):
    """Sphere closest hit and any hit, a dielectric, and a delta light in the
    medium branch: 70 triangles, one glass sphere, a spot light."""
    glass = ('<shape type="sphere"><point name="center" value="0.2 0.6 0.1"/>'
             '<float name="radius" value="0.3"/><bsdf type="dielectric"/></shape>')
    xml = room_xml(tmp_path, LIGHTS["spot"], extra=_strip_obj(tmp_path) + glass)
    js, jc, _ = jbuild.load_scene(xml)
    ts, tc, _ = build.load_scene(xml, device="cpu")
    jc = dataclasses.replace(jc, max_depth=3, rfilter="box")
    tc = dataclasses.replace(tc, max_depth=3, rfilter="box")
    tt, tm = pathk.build_pathk_tables(ts, tc)
    assert tc.n_tris == 70 and tm["t_cnt"] > pathk.VPU_MAX_TRIS and tm["n_sph"] == 1
    ref = render_mega(js, jc, sample_count=4, interpret=True)
    got = render(ts, tc, sample_count=4, device="cpu")
    assert ref["composite"].max() > 0.005
    _assert_films_match(ref["composite"], got["composite"])
    np.testing.assert_allclose(got["albedo"], ref["albedo"], atol=2e-3)
    assert np.all(got["weights"] == 4.0)


def _emissive8_tables(tmp_path):
    """A room lit by a point light and an 8-triangle area light (four quads),
    so that te_cnt = te_pad = 8 and the fallback row te_pad − 1 is a real
    row. The area emitter's CDF column is scaled by 0.9, so that a uniform
    above 0.9 finds no row."""
    quads = [f"v {x0} 1.99 {z0}\nv {x1} 1.99 {z0}\nv {x1} 1.99 {z1}\nv {x0} 1.99 {z1}"
             for x0, x1 in ((-0.4, 0.0), (0.0, 0.4)) for z0, z1 in ((-0.4, 0.0), (0.0, 0.4))]
    faces = [f"f {4 * q + 1} {4 * q + 2} {4 * q + 3} {4 * q + 4}" for q in range(4)]
    (tmp_path / "lamp.obj").write_text("\n".join(quads + faces) + "\n")
    lamp = ('<shape type="obj"><string name="filename" value="lamp.obj"/>'
            '<emitter type="area"><color name="radiance" value="9 8 7"/></emitter></shape>')
    scene, _, _ = build.load_scene(room_xml(tmp_path, LIGHTS["point"], extra=lamp), device="cpu")
    mt = mega.build_mega_tables(scene)
    assert mt["te_cnt"] == 8 and mt["et"].shape[0] == 8
    et = mt["et"].copy()
    et[:, 18] *= 0.9
    et[:, 20] *= 0.9
    return mt["em_rows"], et, mt["env"]


def test_medium_nee_sample_matches_jax_and_takes_the_fallback_row(tmp_path):
    em, et, env = _emissive8_tables(tmp_path)
    n_em, te_pad = em.shape[0], et.shape[0]
    r = np.random.default_rng(11)
    p_hit = (r.random((3, 8, 512)) * [[[1.6]], [[1.5]], [[1.6]]]
             - [[[0.8]], [[-0.2]], [[0.8]]]).astype(np.float32)
    pix = np.arange(8 * 512, dtype=np.uint32).reshape(8, 512)
    jst = jpathk._seed_sampler(jnp.asarray(pix), jnp.asarray(pix * 0 + 5), jnp.uint32(3))
    jst, jr = jmega.nee_sample(jnp.asarray(em), jnp.asarray(et.T.copy()),
                               jnp.asarray(env.reshape(1, 4)), n_em, te_pad,
                               tuple(jnp.asarray(c) for c in p_hit), jst,
                               etc_ref=jnp.asarray(et))
    flat = lambda x: torch.from_numpy(np.ascontiguousarray(x).reshape(-1))
    tst0 = pathk._seed_sampler(flat(pix.astype(np.int64)), 5, 3)
    tp = tuple(flat(c) for c in p_hit)
    args = (torch.from_numpy(em), torch.from_numpy(et), env.tolist(), n_em, 8, tp, tst0)
    tst, tr = pathk._nee_sample_smem(*args, medium=True)
    for a, b in zip(tst, jst):  # the advanced pcg32 state
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).reshape(-1).astype(np.int64))
    for k in ("wi", "value"):
        for c in range(3):
            np.testing.assert_allclose(tr[k][c].numpy(), np.asarray(jr[k][c]).reshape(-1),
                                       rtol=2e-5, atol=2e-6, err_msg=k)
    for k in ("pdf_sa", "shadow_dist"):
        np.testing.assert_allclose(tr[k].numpy(), np.asarray(jr[k]).reshape(-1),
                                   rtol=2e-5, atol=2e-6, err_msg=k)

    # the lanes that take the fallback: area emitter picked, ua above its CDF
    st, u_pick = mega.draw1(tst0)
    _, (ua, _, _) = mega.draw3(st)
    area_id = int(np.flatnonzero(em[:, 0] == mega.EM_AREA)[0])
    eid = (em[None, : n_em - 1, 12] <= u_pick.numpy()[:, None]).sum(axis=1)
    fallback = (eid == area_id) & (ua.numpy() >= et[te_pad - 1, 18])
    assert fallback.sum() > 50
    lit = np.abs(tr["value"][0].numpy()) > 0
    assert lit[fallback].mean() > 0.2  # no `found` term: the fallback row samples
    _, small = pathk._nee_sample_smem(*args)
    assert not np.any(small["value"][0].numpy()[fallback])  # the small branch finds no row
    keep = ~fallback
    for c in range(3):
        np.testing.assert_array_equal(small["value"][c].numpy()[keep],
                                      tr["value"][c].numpy()[keep])


@pytest.mark.parametrize("nu,eligible", [(40, True), (41, False)])
def test_pathk_eligible_up_to_8192_triangles(nu, eligible):
    """nu=40, nv=51 is 12 + 4·40·50 = 8,012 triangles, the top of the medium
    branch; nu=41 is 8,212, which goes to the scan path."""
    scene, config, _ = presets.make_tessellated_cornell(8, 6, 1, "path_mis", nu=nu, nv=51,
                                                        device="cpu")
    assert config.n_tris == 12 + 4 * nu * 50
    assert pathk.pathk_eligible(scene, config) is eligible
    if eligible:
        tables, meta = pathk.build_pathk_tables(scene, config)
        assert meta["t_cnt"] > pathk.VPU_MAX_TRIS and tables["tri"].shape == (8012, pathk.TR_COLS)
