"""Path-tracing device library in plain torch + host table packing.

Counterpart of `optix_renderer_tpu/ops/pallas/mega.py`, which has no
`pallas_call` of its own: it is the component library inside the TPU path
kernel. Here the same functions work on `(x, y, z)` tuples of per-lane
tensors; they are the arithmetic of the plain version of the path kernel
(`ops/cuda/pathk.py: pathk_trace_ref`). The CUDA kernel carries the same
functions per thread in `csrc/mega.cuh`, with the same formulas in the
same order. BSDF semantics follow the reference (diffuse.cpp, mirror.cpp,
dielectric.cpp:52-102, microfacet.cpp:20-160, disney.cpp:111-199).

Integer ids (emitter, sphere) are int64 tensors with −1 for none; a lookup
with an id outside the table returns zeros.
"""

from __future__ import annotations

import numpy as np
import torch

from optix_renderer_tpu_torch.core import rng
from optix_renderer_tpu_torch.scene.data import host_snapshot

BIG = 3.4e38
EPS = 1e-4
PI = 3.14159265358979
INV_PI = 1.0 / PI

# BSDF type codes — must match scene/data.py BsdfType
BSDF_DIFFUSE = 0
BSDF_MIRROR = 1
BSDF_DIELECTRIC = 2
BSDF_MICROFACET = 3
BSDF_DISNEY = 4

# emitter type codes — must match scene/data.py EmitterType
EM_POINT = 0
EM_SPOT = 1
EM_AREA = 2
EM_ENVMAP = 3
EM_DIRECTIONAL = 4

MAX_SPHERES = 64  # above this, the scan path walks the spheres' LBVH (isect_spheres)
MAX_MXU_TRIS = 8192  # the JAX kernel's largest triangle count

# emissive-triangle rows [TE, ET_COLS]
ET_COLS = 24
# 0:3 v0, 3:6 e1, 6:9 e2, 9:12 n0, 12:15 dn1, 15:18 dn2, 18 cdf,
# 19 emitter_id, 20 cdf_lo (previous cdf, for sampleReuse), 21:24 pad

# emitter rows [E, ER_COLS]
ER_COLS = 24
# 0 type, 1:4 radiance, 4:7 position, 7:10 power, 10 area_total,
# 11 pick_pdf, 12 pick_cdf, 13:16 direction, 16 cos_falloff_start,
# 17 cos_falloff_end, 18 angular_radius, 19:24 pad

# sphere rows [Ns, SPH_COLS]: 0:3 center, 3 radius, 4 btype, 5 alpha,
# 6:8 iors, 8 ks, 9:12 kd, 12:15 albedo, 16:26 disney params
SPH_COLS = 32

where = torch.where


# ---------------------------------------------------------------------------
# small vector algebra on (x, y, z) triples of per-lane tensors
# ---------------------------------------------------------------------------


def vdot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vscale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def vadd(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vneg(a):
    return (-a[0], -a[1], -a[2])


def vwhere(m, a, b):
    return (where(m, a[0], b[0]), where(m, a[1], b[1]), where(m, a[2], b[2]))


def vnormalize(a):
    return vscale(a, torch.rsqrt(torch.clamp(vdot(a, a), min=1e-24)))


def safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=0.0))


def onb(n):
    """Duff et al. branchless ONB (same construction as core/math.make_frame)."""
    nx, ny, nz = n
    sign = where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = (1.0 + sign * nx * nx * a, sign * b, -sign * nx)
    t = (b, sign + ny * ny * a, -ny)
    return s, t


def to_local(sf, tf, nf, w):
    return (vdot(sf, w), vdot(tf, w), vdot(nf, w))


def to_world(sf, tf, nf, wl):
    return (
        sf[0] * wl[0] + tf[0] * wl[1] + nf[0] * wl[2],
        sf[1] * wl[0] + tf[1] * wl[1] + nf[1] * wl[2],
        sf[2] * wl[0] + tf[2] * wl[1] + nf[2] * wl[2],
    )


def fresnel_dielectric(cos_i, ext_ior, int_ior):
    """common.h:275 fresnel(), component form; handles both sides."""
    ei = where(cos_i >= 0.0, ext_ior, int_ior)
    et = where(cos_i >= 0.0, int_ior, ext_ior)
    ci = torch.abs(cos_i)
    eta = ei / et
    sin_t2 = eta * eta * torch.clamp(1.0 - ci * ci, min=0.0)
    tir = sin_t2 >= 1.0
    ct = safe_sqrt(1.0 - sin_t2)
    rs = (ei * ci - et * ct) / torch.clamp(torch.abs(ei * ci + et * ct), min=1e-12)
    rp = (et * ci - ei * ct) / torch.clamp(torch.abs(et * ci + ei * ct), min=1e-12)
    f = 0.5 * (rs * rs + rp * rp)
    return where(tir, 1.0, f)


# ---------------------------------------------------------------------------
# host-side table packing
# ---------------------------------------------------------------------------


def mega_unsupported(scene, config) -> str | None:
    """Why this (scene, config) cannot run in the path kernel, or None.

    Clause for clause the JAX package's `mega_eligible`
    (`optix_renderer_tpu/ops/pallas/mega.py:185-240`), which sends such
    scenes to its XLA integrators; `render()` sends them to the scan path
    (`render.scan_step`), which raises where it cannot render them either.
    Each reason names what the kernel does not cover.
    """
    g = scene.geometry
    t_cnt = int(g.tri_v0.shape[0])
    if t_cnt == 0:
        return "a scene without triangles takes the scan path"
    if t_cnt > MAX_MXU_TRIS:
        return (f"{t_cnt} triangles > {MAX_MXU_TRIS}: the path kernel's LBVH walk takes scenes up "
                f"to {MAX_MXU_TRIS}, as the JAX kernel does (larger ones in the kernel are "
                "ROADMAP 'Next' 3)")
    if int(g.sph_center.shape[0]) > MAX_SPHERES:
        return (f"more than {MAX_SPHERES} spheres take the scan path, whose spheres' LBVH walk "
                "(isect_spheres) the path kernel lacks, as the JAX kernel does")
    if config.adaptive:
        return "adaptive configs take the scan path, as in the JAX render()"
    return surface_unsupported(scene, config)


def surface_unsupported(scene, config) -> str | None:
    """The clauses of `mega_unsupported` on the integrator and the scene's
    surface features, without its triangle, sphere and adaptive clauses:
    what the device library of `csrc/mega.cuh` covers, and so the scan
    path's shading kernel too (`ops/cuda/scan.py`). Reads the scene's
    tables through one `host_snapshot`."""
    g = scene.geometry
    n_sph = int(g.sph_center.shape[0])
    sh, b, em = scene.shapes, scene.bsdfs, scene.emitters
    (sh_em, sph_shape, sh_int, sh_ext, sh_ntex, bt, used, tex_type, et, geom_kind) = (
        x.numpy() for x in host_snapshot((
            sh.emitter, g.sph_shape, sh.interior_medium, sh.exterior_medium, sh.normal_tex,
            b.type, b.albedo_tex, scene.textures.type, em.type, em.geom_kind)))
    if n_sph and np.any(sh_em[sph_shape] >= 0):
        return "sphere-area emitters take the scan path"
    if config.integrator not in ("path_mis", "path_mats"):
        return f"integrator '{config.integrator}' takes the scan path"
    if np.any(sh_int >= 0) or np.any(sh_ext >= 0):
        return "a shape with an interior or exterior medium: media take the scan path"
    if scene.ambient_medium >= 0:
        return "an ambient medium: media take the scan path"
    if np.any(sh_ntex >= 0):
        return "normal maps take the scan path"
    if bt.size and bt.max() > BSDF_DISNEY:
        return f"BSDF type {int(bt.max())} takes the scan path"
    used = used[used >= 0]
    if used.size and np.any(tex_type[used] != 0):
        return "checkerboard / image textures take the scan path"
    if et.size == 0:
        return "a scene without an emitter table takes the scan path"
    if np.any(~np.isin(et, (EM_POINT, EM_SPOT, EM_AREA, EM_ENVMAP, EM_DIRECTIONAL))):
        return "volume emitters take the scan path"
    if np.any((et == EM_AREA) & (geom_kind != 1)):
        return "area emitters on other shapes than meshes take the scan path"
    img = scene.envmap.img
    if scene.envmap_emitter >= 0 and img.shape[0] * img.shape[1] != 1:
        return "image-based environment maps take the scan path"
    return None


def mega_eligible(scene, config) -> bool:
    return mega_unsupported(scene, config) is None


def build_mega_tables(scene) -> dict[str, np.ndarray]:
    """Host packing → emitter rows, emissive-triangle rows, constant env and
    sphere rows (`optix_renderer_tpu/ops/pallas/mega.py:243-396`, without
    the TPU-only MXU coefficient and attribute tables)."""
    g = scene.geometry
    npy = lambda t: t.detach().cpu().numpy()
    v0, e1, e2 = npy(g.tri_v0), npy(g.tri_e1), npy(g.tri_e2)
    em = scene.emitters
    etype = npy(em.type)
    E = int(etype.shape[0])

    # ---- emitter rows [E, ER_COLS]
    rows = np.zeros((max(E, 1), ER_COLS), np.float32)
    pick_pdf = npy(scene.emitter_pick.pmf)
    pick_cdf = npy(scene.emitter_pick.cdf)
    for e in range(E):
        rows[e, 0] = float(etype[e])
        rows[e, 1:4] = npy(em.radiance)[e]
        rows[e, 4:7] = npy(em.position)[e]
        rows[e, 7:10] = npy(em.power)[e]
        rows[e, 10] = float(npy(em.area)[e])
        rows[e, 11] = pick_pdf[e] if e < len(pick_pdf) else 0.0
        rows[e, 12] = pick_cdf[e] if e < len(pick_cdf) else 1.0
        rows[e, 13:16] = npy(em.direction)[e]
        rows[e, 16] = float(npy(em.cos_falloff_start)[e])
        rows[e, 17] = float(npy(em.cos_falloff_end)[e])
        rows[e, 18] = float(npy(em.angular_radius)[e])

    # ---- emissive-triangle rows [TEpad, ET_COLS] (mesh-area emitters)
    et_rows = []
    gn0, gn1, gn2 = npy(g.tri_n0), npy(g.tri_n1), npy(g.tri_n2)
    for e in range(E):
        if int(etype[e]) != EM_AREA or int(npy(em.geom_kind)[e]) != 1:
            continue
        off = int(npy(em.tri_offset)[e])
        cdf = npy(em.tri_cdf)[e]
        for k in range(int(npy(em.tri_count)[e])):
            t = off + k
            row = np.zeros(ET_COLS, np.float32)
            row[0:3] = v0[t]
            row[3:6] = e1[t]
            row[6:9] = e2[t]
            row[9:12] = gn0[t]
            row[12:15] = gn1[t] - gn0[t]
            row[15:18] = gn2[t] - gn0[t]
            row[18] = cdf[k]
            row[19] = float(e)
            row[20] = cdf[k - 1] if k > 0 else 0.0
            et_rows.append(row)
    te = len(et_rows)
    te_pad = max(8, int(np.ceil(max(te, 1) / 8) * 8))
    et_tab = np.zeros((te_pad, ET_COLS), np.float32)
    et_tab[:, 19] = -1.0  # pad rows match no emitter
    et_tab[:, 18] = 2.0  # pad cdf beyond any u
    if te:
        et_tab[:te] = np.stack(et_rows)

    # ---- sphere rows [Ns, SPH_COLS] (non-emissive by eligibility)
    btype = npy(scene.bsdfs.type)
    tex_val = npy(scene.textures.value)
    ns_ = int(g.sph_center.shape[0])
    sph = np.zeros((max(ns_, 1), SPH_COLS), np.float32)
    if ns_:
        s_bsdf = npy(scene.shapes.bsdf)[npy(g.sph_shape)]
        sph[:ns_, 0:3] = npy(g.sph_center)
        sph[:ns_, 3] = npy(g.sph_radius)
        sph[:ns_, 4] = btype[s_bsdf]
        sph[:ns_, 5] = npy(scene.bsdfs.alpha)[s_bsdf]
        sph[:ns_, 6] = npy(scene.bsdfs.int_ior)[s_bsdf]
        sph[:ns_, 7] = npy(scene.bsdfs.ext_ior)[s_bsdf]
        sph[:ns_, 8] = npy(scene.bsdfs.ks)[s_bsdf]
        sph[:ns_, 9:12] = npy(scene.bsdfs.kd)[s_bsdf]
        s_alb = npy(scene.bsdfs.albedo_tex)[s_bsdf]
        sph[:ns_, 12:15] = np.where((s_alb >= 0)[:, None], tex_val[np.maximum(s_alb, 0)], 1.0)
        sph[:ns_, 16:26] = npy(scene.bsdfs.disney)[s_bsdf]

    # constant-envmap radiance, its 1×1 table (0 if none), + presence flag
    env_rad = np.zeros(4, np.float32)
    if scene.envmap_emitter >= 0:
        env_rad[:3] = npy(scene.envmap.img)[0, 0]
        env_rad[3] = 1.0
    return {"em_rows": rows, "et": et_tab, "te_cnt": te, "env": env_rad, "sph": sph}


# ---------------------------------------------------------------------------
# intersection and per-lane table reads
# ---------------------------------------------------------------------------


def sphere_hit(sph, o, d, mint, cutoff):
    """Stable-quadratic sphere test against the sphere rows (sphere.cpp:67-124).
    Returns (t, sid int64 with −1 for a miss). Rows with radius ≤ 0 are
    padding and never hit."""
    best_t = cutoff
    best_id = torch.full_like(cutoff, -1, dtype=torch.int64)
    a = vdot(d, d)
    for j, row in enumerate(sph.tolist()):
        cx, cy, cz, r = row[0:4]
        if r <= 0.0:
            continue
        oc = (o[0] - cx, o[1] - cy, o[2] - cz)
        b = 2.0 * vdot(oc, d)
        c = vdot(oc, oc) - r * r
        disc = b * b - 4.0 * a * c
        ok = disc >= 0.0
        sq = safe_sqrt(disc)
        q = -0.5 * (b + torch.sign(b) * sq)
        t0 = q / a
        t1 = c / where(torch.abs(q) > 1e-20, q, 1e-20)
        tn = torch.minimum(t0, t1)
        tf_ = torch.maximum(t0, t1)
        in_n = ok & (tn >= mint) & (tn < best_t)
        in_f = ok & (tf_ >= mint) & (tf_ < best_t)
        t_c = where(in_n, tn, where(in_f, tf_, BIG))
        better = t_c < best_t
        best_t = where(better, t_c, best_t)
        best_id = where(better, j, best_id)
    return best_t, best_id


def _rows(table, ids, n_rows):
    """Per-lane rows of `table` for `ids`; (rows, mask of ids in [0, n_rows))."""
    ok = (ids >= 0) & (ids < n_rows)
    return table[ids.clamp(0, max(n_rows - 1, 0))], ok


def sphere_params(sph, sid, P, ns_tri, p_hit):
    """Override per-lane BSDF params + shading normal where a sphere won."""
    R, is_s = _rows(sph, sid, sph.shape[0])
    fields = {"btype": 4, "alpha": 5, "int_ior": 6, "ext_ior": 7, "ks": 8}
    out = dict(P)
    for k, c in fields.items():
        out[k] = where(is_s, R[:, c], P[k])
    out["kd"] = tuple(where(is_s, R[:, 9 + c], P["kd"][c]) for c in range(3))
    out["albedo"] = tuple(where(is_s, R[:, 12 + c], P["albedo"][c]) for c in range(3))
    if "disney" in P:
        out["disney"] = tuple(where(is_s, R[:, 16 + c], P["disney"][c]) for c in range(10))
    # outward normal (p-c)/r (sphere.cpp:87-124)
    inv_r = 1.0 / torch.clamp(R[:, 3], min=1e-12)
    n = tuple(where(is_s, (p_hit[c] - R[:, c]) * inv_r, ns_tri[c]) for c in range(3))
    return out, n, is_s


def emitter_lookup(em, n_emitters, eid, cols):
    """Per-lane emitter row fields; zeros where `eid` is −1 (or ≥ n_emitters)."""
    R, ok = _rows(em, eid, n_emitters)
    return [where(ok, R[:, j], 0.0) for j in cols]


# -- pcg32 draws --------------------------------------------------------------


def draw1(st):
    return rng.pcg32_next_float(st)


def draw2(st):
    st, u1 = draw1(st)
    st, u2 = draw1(st)
    return st, (u1, u2)


def draw3(st):
    st, u1 = draw1(st)
    st, u2 = draw1(st)
    st, u3 = draw1(st)
    return st, (u1, u2, u3)


# ---------------------------------------------------------------------------
# BSDF sample / eval / pdf (same reference semantics as ops/bsdf.py)
# ---------------------------------------------------------------------------


def _cosine_hemisphere(u1, u2):
    rho = torch.sqrt(torch.clamp(u1, min=0.0))
    th = u2 * (2.0 * PI)
    x = rho * torch.cos(th)
    y = rho * torch.sin(th)
    z = safe_sqrt(1.0 - (x * x + y * y))
    return (x, y, z)


def _beckmann_sample(u1, u2, alpha):
    log_s = torch.log(torch.clamp(1.0 - u1, min=1e-38))
    tan2 = -alpha * alpha * log_s
    phi = u2 * (2.0 * PI)
    ct = 1.0 / torch.sqrt(1.0 + tan2)
    st_ = safe_sqrt(1.0 - ct * ct)
    return (st_ * torch.cos(phi), st_ * torch.sin(phi), ct)


def _beckmann_d(m, alpha):
    ct = torch.clamp(m[2], min=1e-4)
    inv_ct2 = 1.0 / (ct * ct)
    tan2 = torch.clamp(1.0 - ct * ct, min=0.0) * inv_ct2
    return torch.exp(-tan2 / (alpha * alpha)) * inv_ct2 * inv_ct2 / (PI * alpha * alpha)


def _smith_g1(v, m, alpha):
    ct = v[2]
    tan_t = safe_sqrt(1.0 - ct * ct) / where(torch.abs(ct) > 1e-8, ct, 1e-8)
    a = 1.0 / torch.clamp(alpha * torch.abs(tan_t), min=1e-8)
    a2 = a * a
    approx = (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2)
    g = where(a >= 1.6, 1.0, approx)
    g = where(torch.abs(tan_t) < 1e-8, 1.0, g)
    back = vdot(m, v) * ct <= 0.0
    return where(back, 0.0, g)


def _microfacet_eval_c(kd, ks, alpha, ext_ior, int_ior, wi, wo):
    wh = vnormalize(vadd(wi, wo))
    d = _beckmann_d(wh, alpha)
    f = fresnel_dielectric(vdot(wh, wi), ext_ior, int_ior)
    g = _smith_g1(wi, wh, alpha) * _smith_g1(wo, wh, alpha)
    denom = 4.0 * wi[2] * wo[2]
    spec = ks * d * f * g / where(torch.abs(denom) > 1e-12, denom, 1e-12)
    ok = wo[2] > 0.0
    return tuple(where(ok, kd[c] * INV_PI + spec, 0.0) for c in range(3))


def _microfacet_pdf_c(ks, alpha, wi, wo):
    wh = vnormalize(vadd(wi, wo))
    d = _beckmann_d(wh, alpha)
    dwh = vdot(wo, wh)
    part1 = ks * d * wh[2] / where(torch.abs(4.0 * dwh) > 1e-12, 4.0 * dwh, 1e-12)
    part2 = (1.0 - ks) * wo[2] * INV_PI
    return where(wo[2] > 0.0, part1 + part2, 0.0)


def _schlick_fresnel_c(a):
    m = torch.clamp(1.0 - a, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def _smith_g_ggx_aniso_c(ndotv, vdotx, vdoty, ax, ay):
    return 1.0 / torch.clamp(
        ndotv + torch.sqrt(vdotx * ax * vdotx * ax + vdoty * ay * vdoty * ay + ndotv * ndotv),
        min=1e-8,
    )


def _smith_g_ggx_c(ndotv, alpha_g):
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / torch.clamp(ndotv + torch.sqrt(a + b - a * b), min=1e-8)


def disney_eval_c(P, wi, wo):
    """Disney BRDF (disney.cpp:111-176); base color = P["albedo"], params =
    P["disney"] (10-tuple)."""
    (metallic, subsurface, specular, roughness, specular_tint, anisotropic,
     sheen, sheen_tint, clearcoat, clearcoat_gloss) = P["disney"]
    Lv, Vv = wi, wo
    ndotl = Lv[2]
    ndotv = Vv[2]
    valid = (ndotl >= EPS) & (ndotv >= EPS)
    H = vnormalize(vadd(Lv, Vv))
    ndoth = H[2]
    ldoth = vdot(Lv, H)

    cdlin = tuple(torch.pow(torch.clamp(P["albedo"][c], min=1e-6), 2.2) for c in range(3))
    cdlum = 0.3 * cdlin[0] + 0.6 * cdlin[1] + 0.1 * cdlin[2]
    inv_lum = 1.0 / torch.clamp(cdlum, min=1e-12)
    ctint = tuple(where(cdlum > 0.0, cdlin[c] * inv_lum, 1.0) for c in range(3))
    cspec0 = tuple(
        (specular * 0.08 * (1.0 + (ctint[c] - 1.0) * specular_tint)) * (1.0 - metallic)
        + cdlin[c] * metallic
        for c in range(3)
    )
    csheen = tuple(1.0 + (ctint[c] - 1.0) * sheen_tint for c in range(3))

    fl = _schlick_fresnel_c(ndotl)
    fv = _schlick_fresnel_c(ndotv)
    fd90 = 0.5 + 2.0 * ldoth * ldoth * roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fss90 = ldoth * ldoth * roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / torch.clamp(ndotl + ndotv, min=1e-8) - 0.5) + 0.5)

    aspect = torch.sqrt(1.0 - anisotropic * 0.9)
    ax = torch.clamp(roughness * roughness / aspect, min=0.001)
    ay = torch.clamp(roughness * roughness * aspect, min=0.001)
    hx = H[0] / ax
    hy = H[1] / ay
    base = hx * hx + hy * hy + ndoth * ndoth
    denom = PI * ax * ay * (base * base)
    ds = 1.0 / torch.clamp(denom, min=1e-12)
    fh = _schlick_fresnel_c(ldoth)
    fs = tuple(cspec0[c] + (1.0 - cspec0[c]) * fh for c in range(3))
    gs = (_smith_g_ggx_aniso_c(ndotl, Lv[0], Lv[1], ax, ay)
          * _smith_g_ggx_aniso_c(ndotv, Vv[0], Vv[1], ax, ay))
    fsheen = tuple(fh * sheen * csheen[c] for c in range(3))

    # GTR1 clearcoat lobe (disney.cpp: mix(0.1, 0.001, gloss))
    a_cc = torch.clamp(0.1 + (0.001 - 0.1) * clearcoat_gloss, min=1e-4)
    a2 = a_cc * a_cc
    t_cc = 1.0 + (a2 - 1.0) * ndoth * ndoth
    dr = where(a_cc >= 1.0, INV_PI, (a2 - 1.0) / (PI * torch.log(a2) * t_cc))
    fr = 0.04 + 0.96 * fh
    gr = _smith_g_ggx_c(ndotl, 0.25) * _smith_g_ggx_c(ndotv, 0.25)

    diff_mix = fd + (ss - fd) * subsurface
    final = tuple(
        (INV_PI * diff_mix * cdlin[c] + fsheen[c]) * (1.0 - metallic)
        + gs * ds * fs[c]
        + 0.25 * clearcoat * gr * fr * dr
        for c in range(3)
    )
    lum = final[0] * 0.212671 + final[1] * 0.715160 + final[2] * 0.072169
    inv_l = 1.0 / torch.clamp(lum, min=1e-12)
    final = tuple(where(lum > 1.0, final[c] * inv_l, final[c]) for c in range(3))
    return tuple(where(valid, final[c], 0.0) for c in range(3))


def bsdf_eval_c(P, wi, wo):
    """f(wi,wo) rgb under solid angle; P = per-lane param dict."""
    diff_ok = (wi[2] > 0.0) & (wo[2] > 0.0)
    f_diff = tuple(where(diff_ok, P["albedo"][c] * INV_PI, 0.0) for c in range(3))
    f_mf = _microfacet_eval_c(P["kd"], P["ks"], P["alpha"], P["ext_ior"], P["int_ior"], wi, wo)
    is_diff = P["btype"] == BSDF_DIFFUSE
    is_mf = P["btype"] == BSDF_MICROFACET
    is_dis = P["btype"] == BSDF_DISNEY
    f_dis = disney_eval_c(P, wi, wo) if "disney" in P else (0.0, 0.0, 0.0)
    return tuple(
        where(is_diff, f_diff[c], where(is_mf, f_mf[c], where(is_dis, f_dis[c], 0.0)))
        for c in range(3)
    )


def bsdf_pdf_c(P, wi, wo):
    diff_ok = (wi[2] > 0.0) & (wo[2] > 0.0)
    p_diff = where(diff_ok, INV_PI * wo[2], 0.0)
    p_mf = _microfacet_pdf_c(P["ks"], P["alpha"], wi, wo)
    is_cos = (P["btype"] == BSDF_DIFFUSE) | (P["btype"] == BSDF_DISNEY)
    return where(is_cos, p_diff, where(P["btype"] == BSDF_MICROFACET, p_mf, 0.0))


def bsdf_sample_c(P, wi, u1, u2):
    """Sample wo; returns (wo triple, weight rgb triple, pdf, is_discrete)."""
    cos_i = wi[2]
    one = torch.ones_like(cos_i)

    # diffuse
    wo_diff = _cosine_hemisphere(u1, u2)
    w_diff = tuple(where(cos_i > 0.0, P["albedo"][c], 0.0) for c in range(3))

    # mirror
    wo_mirror = (-wi[0], -wi[1], wi[2])
    w_mirror = (where(cos_i > 0.0, one, 0.0),) * 3

    # dielectric (dielectric.cpp:52-102)
    fr = fresnel_dielectric(cos_i, P["ext_ior"], P["int_ior"])
    reflect_event = u1 < fr
    entering = cos_i >= 0.0
    eta_ratio = where(entering, P["ext_ior"] / P["int_ior"], P["int_ior"] / P["ext_ior"])
    nz = where(entering, 1.0, -1.0)
    wi_dot_n = wi[2] * nz
    sq = safe_sqrt(1.0 - eta_ratio * eta_ratio * (1.0 - wi_dot_n * wi_dot_n))
    wo_refr = (
        -eta_ratio * wi[0],
        -eta_ratio * wi[1],
        -eta_ratio * (wi[2] - wi_dot_n * nz) - sq * nz,
    )
    wo_diel = vwhere(reflect_event, wo_mirror, wo_refr)
    w_refr = 1.0 / (eta_ratio * eta_ratio)
    w_diel = (where(reflect_event, 1.0, w_refr),) * 3

    # microfacet (microfacet.cpp:123-160)
    ks = P["ks"]
    alpha = P["alpha"]
    spec_event = u2 < ks
    u2_spec = u2 / torch.clamp(ks, min=1e-8)
    u2_diff = (u2 - ks) / torch.clamp(1.0 - ks, min=1e-8)
    wh = _beckmann_sample(u1, u2_spec, alpha)
    dw = 2.0 * vdot(wi, wh)
    wo_spec = (dw * wh[0] - wi[0], dw * wh[1] - wi[1], dw * wh[2] - wi[2])
    wo_cos = _cosine_hemisphere(u1, u2_diff)
    wo_mf = vwhere(spec_event, wo_spec, wo_cos)
    f_mf = _microfacet_eval_c(P["kd"], ks, alpha, P["ext_ior"], P["int_ior"], wi, wo_mf)
    p_mf = _microfacet_pdf_c(ks, alpha, wi, wo_mf)
    mf_ok = (wo_mf[2] > 0.0) & (cos_i >= 0.0) & (p_mf > 1e-12)
    scale = where(mf_ok, wo_mf[2] / torch.clamp(p_mf, min=1e-12), 0.0)
    w_mf = tuple(f_mf[c] * scale for c in range(3))

    is_mirror = P["btype"] == BSDF_MIRROR
    is_diel = P["btype"] == BSDF_DIELECTRIC
    is_mf = P["btype"] == BSDF_MICROFACET
    is_dis = P["btype"] == BSDF_DISNEY

    # disney (disney.cpp:181-199): cosine sample, weight f·π
    if "disney" in P:
        f_dis = disney_eval_c(P, wi, wo_diff)
        p_dis = INV_PI * torch.clamp(wo_diff[2], min=0.0)
        dis_ok = (cos_i > 0.0) & (p_dis >= EPS)
        w_dis = tuple(where(dis_ok, f_dis[c] * PI, 0.0) for c in range(3))
    else:
        w_dis = w_diff

    wo = vwhere(is_mirror, wo_mirror, vwhere(is_diel, wo_diel, vwhere(is_mf, wo_mf, wo_diff)))
    weight = tuple(
        where(is_mirror, w_mirror[c], where(is_diel, w_diel[c],
              where(is_mf, w_mf[c], where(is_dis, w_dis[c], w_diff[c]))))
        for c in range(3)
    )
    is_discrete = is_mirror | is_diel
    pdf_cont = where(
        is_mf, p_mf,
        where(((P["btype"] == BSDF_DIFFUSE) | is_dis) & (cos_i > 0.0),
              INV_PI * torch.clamp(wo[2], min=0.0), 0.0),
    )
    pdf = where(is_discrete, 0.0, pdf_cont)
    return wo, weight, pdf, is_discrete
