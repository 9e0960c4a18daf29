"""The port's plain-torch device library against `optix_renderer_tpu.ops.pallas.mega`
(and the small-scene helpers of `pathk`) on the same inputs, made with numpy.

Tolerances are those of tests/test_mega.py:93-104, 156-158, 337 (BSDF sample
rtol/atol 2e-4/2e-5 for directions, 3e-4 for weights and pdfs; eval 3e-4/
3e-5; Disney 2e-3/2e-4). Integer results (ids, masks) must be equal.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one intra-op thread each

from optix_renderer_tpu.ops.pallas import mega as jmega
from optix_renderer_tpu.ops.pallas import pathk as jpathk
from optix_renderer_tpu_torch.core import rng as trng
from optix_renderer_tpu_torch.ops.cuda import mega, pathk

N = 512


def _dirs(r, upper=False, flip=0):
    w = r.normal(size=(N, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=-1, keepdims=True)
    if upper:
        w[:, 2] = np.abs(w[:, 2])
    w[:flip, 2] *= -1
    return w


def _params(r, btype):
    """Per-lane BSDF params as numpy columns (random disney params + albedo)."""
    return {
        "btype": np.full(N, float(btype), np.float32),
        "alpha": np.full(N, 0.2, np.float32),
        "int_ior": np.full(N, 1.5046, np.float32),
        "ext_ior": np.full(N, 1.000277, np.float32),
        "ks": np.full(N, 0.6, np.float32),
        "kd": tuple(np.full(N, v, np.float32) for v in (0.4, 0.3, 0.2)),
        "albedo": tuple((r.random(N) * 0.9 + 0.05).astype(np.float32) for _ in range(3)),
        "disney": tuple(r.random(N).astype(np.float32) for _ in range(10)),
    }


def _as(P, f):
    return {k: tuple(f(x) for x in v) if isinstance(v, tuple) else f(v) for k, v in P.items()}


def _tri(w, f):
    return tuple(f(w[:, c]) for c in range(3))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("btype", [0, 1, 2, 3, 4])
def test_bsdf_sample_matches_jax(btype):
    r = np.random.default_rng(btype)
    wi = _dirs(r, flip=N // 8)
    u = r.random((2, N)).astype(np.float32)
    P = _params(r, btype)
    jwo, jw, jpdf, jdisc = jmega.bsdf_sample_c(_as(P, jnp.asarray), _tri(wi, jnp.asarray),
                                               jnp.asarray(u[0]), jnp.asarray(u[1]))
    two, tw, tpdf, tdisc = mega.bsdf_sample_c(_as(P, torch.from_numpy), _tri(wi, torch.from_numpy),
                                              torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    for c in range(3):
        np.testing.assert_allclose(_np(two[c]), _np(jwo[c]), rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(_np(tw[c]), _np(jw[c]), rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(_np(tpdf), _np(jpdf), rtol=3e-4, atol=3e-4)
    np.testing.assert_array_equal(_np(tdisc), _np(jdisc))


@pytest.mark.parametrize("btype", [0, 1, 2, 3, 4])
def test_bsdf_eval_pdf_match_jax(btype):
    r = np.random.default_rng(10 + btype)
    wi, wo = _dirs(r, upper=True), _dirs(r, flip=N // 8)
    P = _params(r, btype)
    jP, tP = _as(P, jnp.asarray), _as(P, torch.from_numpy)
    jwi, jwo = _tri(wi, jnp.asarray), _tri(wo, jnp.asarray)
    twi, two = _tri(wi, torch.from_numpy), _tri(wo, torch.from_numpy)
    jf, tf = jmega.bsdf_eval_c(jP, jwi, jwo), mega.bsdf_eval_c(tP, twi, two)
    tol = dict(rtol=2e-3, atol=2e-4) if btype == 4 else dict(rtol=3e-4, atol=3e-5)
    for c in range(3):
        np.testing.assert_allclose(_np(tf[c]), _np(jf[c]), **tol)
    np.testing.assert_allclose(_np(mega.bsdf_pdf_c(tP, twi, two)),
                               _np(jmega.bsdf_pdf_c(jP, jwi, jwo)), rtol=3e-4, atol=3e-5)


def test_disney_eval_matches_jax():
    r = np.random.default_rng(11)
    wi, wo = _dirs(r, upper=True), _dirs(r, upper=True)
    P = _params(r, 4)
    jf = jmega.disney_eval_c(_as(P, jnp.asarray), _tri(wi, jnp.asarray), _tri(wo, jnp.asarray))
    tf = mega.disney_eval_c(_as(P, torch.from_numpy), _tri(wi, torch.from_numpy),
                            _tri(wo, torch.from_numpy))
    for c in range(3):
        np.testing.assert_allclose(_np(tf[c]), _np(jf[c]), rtol=2e-3, atol=2e-4)


def test_fresnel_and_onb_match_jax():
    r = np.random.default_rng(3)
    cos_i = (r.random(N) * 2 - 1).astype(np.float32)
    ext = (1.0 + r.random(N)).astype(np.float32)
    inn = (1.0 + r.random(N)).astype(np.float32)
    np.testing.assert_allclose(
        _np(mega.fresnel_dielectric(*(torch.from_numpy(x) for x in (cos_i, ext, inn)))),
        _np(jmega.fresnel_dielectric(*(jnp.asarray(x) for x in (cos_i, ext, inn)))),
        rtol=1e-6, atol=1e-6)
    n = _dirs(r)
    for jv, tv in zip(jmega.onb(_tri(n, jnp.asarray)), mega.onb(_tri(n, torch.from_numpy))):
        for c in range(3):
            np.testing.assert_allclose(_np(tv[c]), _np(jv[c]), rtol=1e-5, atol=1e-6)


def test_sphere_hit_matches_jax():
    r = np.random.default_rng(4)
    sph = np.zeros((3, mega.SPH_COLS), np.float32)  # two spheres + one pad row
    sph[0, :4] = (-0.45, 0.35, -0.35, 0.35)
    sph[1, :4] = (0.45, 0.35, 0.4, 0.35)
    o = (r.random((N, 3)) * [2, 2, 2] - [1, 0, -3]).astype(np.float32)
    target = (r.random((N, 3)) * [1.2, 0.8, 1.2] - [0.6, -0.1, 0.4]).astype(np.float32)
    d = target - o
    mint = np.full(N, 1e-4, np.float32)
    cut = np.where(r.random(N) < 0.3, 2.0, 3.4e38).astype(np.float32)
    jt, jid = jmega.sphere_hit(jnp.asarray(sph), _tri(o, jnp.asarray), _tri(d, jnp.asarray),
                               jnp.asarray(mint), jnp.asarray(cut))
    tt, tid = mega.sphere_hit(torch.from_numpy(sph), _tri(o, torch.from_numpy),
                              _tri(d, torch.from_numpy), torch.from_numpy(mint),
                              torch.from_numpy(cut))
    np.testing.assert_array_equal(_np(tid), _np(jid).astype(np.int64))
    assert (_np(tid) >= 0).mean() > 0.2
    np.testing.assert_allclose(_np(tt), _np(jt), rtol=1e-6)


def test_emitter_lookup_matches_jax_and_zeroes_missing_ids():
    r = np.random.default_rng(5)
    em = r.random((3, mega.ER_COLS)).astype(np.float32)
    eid = r.integers(-1, 3, size=N)
    cols = [0, 1, 2, 3, 10, 12, 18]
    jv = jmega.emitter_lookup(jnp.asarray(em), 3, jnp.asarray(eid.astype(np.float32)), cols)
    tv = mega.emitter_lookup(torch.from_numpy(em), 3, torch.from_numpy(eid), cols)
    for a, b in zip(tv, jv):
        np.testing.assert_array_equal(_np(a), _np(b))
        assert np.all(_np(a)[eid < 0] == 0.0)


def test_fis_jitter_and_camera_ray_match_jax():
    r = np.random.default_rng(6)
    u1, u2 = r.random(N).astype(np.float32), r.random(N).astype(np.float32)
    for name in ("box", "tent", "gaussian"):
        jj = jpathk._fis_jitter2(jnp.asarray(u1), jnp.asarray(u2), name)
        tj = pathk._fis_jitter2(torch.from_numpy(u1), torch.from_numpy(u2), name)
        for a, b in zip(tj, jj):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=2e-6)

    from optix_renderer_tpu.scene.presets import make_cornell_box

    scene, config, _ = make_cornell_box(width=40, height=30, spp=1)
    jt, _ = jpathk.build_pathk_tables(scene, config)
    sf = np.asarray(jt["scal_f"]).copy()
    pix = r.integers(0, 40 * 30, size=N).astype(np.uint32)
    px, py = (pix % 40).astype(np.float32), (pix // 40).astype(np.float32)
    for use_dof in (False, True):
        if use_dof:
            sf[0, 32], sf[0, 33] = 0.05, 4.0
        for name in ("box", "gaussian"):
            jst = jpathk._seed_sampler(jnp.asarray(pix), jnp.asarray(pix * 0 + 3), jnp.uint32(7))
            tst = pathk._seed_sampler(torch.from_numpy(pix.astype(np.int64)), 3, 7)
            for a, b in zip(tst, jst):
                np.testing.assert_array_equal(_np(a), _np(b).astype(np.int64))
            jo = jpathk._camera_ray(jnp.asarray(sf), jnp.asarray(px), jnp.asarray(py),
                                    jst, rfilter=name, use_dof=use_dof)
            to = pathk._camera_ray(torch.from_numpy(sf[0]), torch.from_numpy(px),
                                   torch.from_numpy(py), trng.Pcg32State(*tst),
                                   rfilter=name, use_dof=use_dof)
            for a, b in zip(to[0], jo[0]):  # the advanced pcg32 state
                np.testing.assert_array_equal(_np(a), _np(b).astype(np.int64))
            for a, b in zip(to[1:3], jo[1:3]):  # o, d
                for c in range(3):
                    np.testing.assert_allclose(_np(a[c]), _np(b[c]), rtol=1e-5, atol=1e-5)
            for a, b in zip(to[3:], jo[3:]):  # mint, maxt
                np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5)
