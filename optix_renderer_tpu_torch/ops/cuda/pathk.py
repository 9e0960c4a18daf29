"""Regenerating path tracer: table packing, plain torch version, kernel wrapper.

Counterpart of `optix_renderer_tpu/ops/pallas/pathk.py` (`pathk_trace` →
`_pathk_kernel`), both branches: the small-scene branch (≤ VPU_MAX_TRIS
triangles) and the medium branch (up to MAX_MXU_TRIS, the JAX kernel's
MXU branch). Each pixel seeds pcg32 from `tea(pix, (spp0 + k) ^ seed)` for
its sample k, makes a
camera ray with filter-importance-sampled jitter, and traces bounces; each
bounce finds the closest hit of the current ray and the any hit of the
shadow ray queued by the previous bounce. NEE uses the balance
heuristic (`path_mis`) or is off (`path_mats`), then Russian roulette. When
a path ends the pixel regenerates its next sample until `n_spp` are done,
and it stops once it has no active path and no pending shadow ray.

Two versions with one contract, both returning float32 `[16, n_pix]`:

* `pathk_trace_ref` — plain torch, vectorised over pixels with per-lane
  masks. It is what `pathk_trace` runs for CPU tensors.
* the CUDA kernels of `csrc/pathk.cu`, which `pathk_trace` launches for
  CUDA tensors; there is no fallback between the two. Each pixel is traced
  whole by one thread; persistent blocks take their pixels from a counter
  that the wrapper allocates (the small branch's lanes one pixel at a time
  as each finishes, the medium branch's warps 32 at a time). Every pixel
  runs on its own, so which thread runs it, and when, does not change its
  rows.

Output rows: 0:3 ΣL rgb, 3 samples done, 4:7 Σ first-hit albedo,
7:10 Σ first-hit shading normal, 10 loop iterations, 11:16 zero.

The small branch sweeps the triangle rows; the medium branch (`t_cnt >
VPU_MAX_TRIS`) walks the scene's LBVH (`ops/bvh.py`, the `packed` and
`leaf` tables; `csrc/walk.cuh`) for the closest hit and for the shadow
ray's any hit. Both take as winner the lowest-index minimum of the
Möller–Trumbore t (the walk breaks an exact tie in t by the smaller id),
and the kernel reads the winner's row once. The JAX MXU branch picks its
winner on the matmul form of t and then refines it with Möller–Trumbore, so
on near-ties (≤ 0.1 % of the rays) the two can pick different triangles.
The branches also differ in the emissive-triangle pick of NEE
(`mega.py: nee_sample`, 923-925): the medium branch scans the whole padded
table (`te_pad` rows), falls back to row `te_pad − 1` when no row
qualifies, and has no `found` term in its area-sample validity.

Contract notes:

* Row 10 is a per-pixel iteration count. The TPU kernel writes one count
  per 4096-pixel block (`bench.py` reads it per block); here every pixel
  runs its own loop and reports its own count.
* Row 3 holds sample counts, so the film's `weights` layer on this path is
  the number of samples per pixel, not a sum of filter weights as on the
  JAX package's splat path (`render/render.py: _layers_out`). Compare
  `weights` only with another path-kernel film.
* Russian roulette and dielectric events flip on floating-point
  association, so parity with the JAX kernel is statistical per pixel
  (median relative error), never exact equality.

The pcg32 draws are consumed in the TPU kernel's order: seeding, jitter 2
+ aperture 2, RR 1, NEE pick 1 + 3 (path_mis only), BSDF 2.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from optix_renderer_tpu_torch.core import rng
from optix_renderer_tpu_torch.ops import bvh
from optix_renderer_tpu_torch.ops.camera import sample_to_camera_matrix
from optix_renderer_tpu_torch.ops.cuda import isect, mega
from optix_renderer_tpu_torch.ops.cuda.mega import (
    BIG,
    EM_AREA,
    EM_DIRECTIONAL,
    EM_POINT,
    EM_SPOT,
    EPS,
    PI,
    bsdf_eval_c,
    bsdf_pdf_c,
    bsdf_sample_c,
    draw1,
    draw2,
    draw3,
    emitter_lookup,
    onb,
    safe_sqrt,
    sphere_hit,
    sphere_params,
    to_local,
    to_world,
    vadd,
    vdot,
    vneg,
    vnormalize,
    vscale,
    vsub,
    vwhere,
    where,
)
from optix_renderer_tpu_torch.scene.data import host_snapshot

VPU_MAX_TRIS = 64  # above this, the medium branch (the JAX kernel's MXU branch)
OUT_ROWS = 16
FILTERS = {"box": 0, "tent": 1, "gaussian": 2}

# triangle rows [T, TR_COLS]
TR_COLS = 48
# 0:3 v0, 3:6 e1, 6:9 e2, 9:12 n_g(unit), 12:15 n0, 15:18 dn1, 18:21 dn2,
# 21 btype, 22 alpha, 23 int_ior, 24 ext_ior, 25 ks, 26:29 kd, 29:32 albedo,
# 32 em_id, 33:43 disney params (disney.cpp:32-41 order), 43:48 pad

# float scalar pack [SF_COLS]
# 0:16 sample_to_camera (row-major), 16:32 camera to_world (row-major),
# 32 lens_radius, 33 focal_distance, 34 near_clip, 35 far_clip,
# 36 1/width, 37 1/height, 38:40 pad
SF_COLS = 40

# kernel launches by `pathk_trace` (not by the plain version)
LAUNCHES = 0


# ---------------------------------------------------------------------------
# host-side packing
# ---------------------------------------------------------------------------


def pathk_unsupported(scene, config) -> str | None:
    """Why this (scene, config) cannot take the path-kernel contract, or None."""
    if config.rfilter not in FILTERS:
        return (f"the '{config.rfilter}' filter cannot be importance-sampled and "
                "takes the scan path's splat film")
    return mega.mega_unsupported(scene, config)


def pathk_eligible(scene, config) -> bool:
    return pathk_unsupported(scene, config) is None


# the scene's tables that the packing reads (`build_mega_tables` included)
_PACKED = ("geometry", "shapes", "bsdfs", "textures", "emitters", "emitter_pick", "camera",
           "envmap")


def build_pathk_tables(scene, config, device="cpu"):
    """Host packing → (dict of float32 tensors on `device`, static metadata).

    Tables: `tri` [max(T,1), 48], `et` [TEpad, 24] (the JAX `etc`; the
    small branch reads its first `te_cnt` rows, the JAX `et_smem`),
    `em_rows` [E, 24], `env` [4], `sph` [max(Ns,1), 32], `scal_f` [40],
    and the medium branch's LBVH, `packed` [Nn, 8] and `leaf`
    [n_leaves, 40] (`ops/bvh.py`; one zero row each in the small branch).
    The LBVH is the scene's own when it has one; else it is built here from
    v0 | e1 | e2, so that every leaf slot holds its row's columns 0:9 bit
    for bit. A scene on the card comes to the host in one snapshot of the
    tables it reads (`host_snapshot`: one wait).
    """
    if scene.geometry.tri_v0.is_cuda:
        scene = dataclasses.replace(scene,
                                    **host_snapshot({k: getattr(scene, k) for k in _PACKED}))
    npy = lambda t: t.detach().cpu().numpy()
    g = scene.geometry
    t_cnt = int(g.tri_v0.shape[0])
    mt = mega.build_mega_tables(scene)
    te_cnt = mt["te_cnt"]

    v0, e1, e2 = npy(g.tri_v0), npy(g.tri_e1), npy(g.tri_e2)
    tri = np.zeros((max(t_cnt, 1), TR_COLS), np.float32)
    n_g = np.cross(e1, e2)
    n_g /= np.maximum(np.linalg.norm(n_g, axis=-1, keepdims=True), 1e-20)
    n0 = npy(g.tri_n0)
    tri[:t_cnt, 0:3] = v0
    tri[:t_cnt, 3:6] = e1
    tri[:t_cnt, 6:9] = e2
    tri[:t_cnt, 9:12] = n_g
    tri[:t_cnt, 12:15] = n0
    tri[:t_cnt, 15:18] = npy(g.tri_n1) - n0
    tri[:t_cnt, 18:21] = npy(g.tri_n2) - n0
    shape_id = npy(g.tri_shape)
    bsdf_id = npy(scene.shapes.bsdf)[shape_id]
    b = scene.bsdfs
    tri[:t_cnt, 21] = npy(b.type)[bsdf_id]
    tri[:t_cnt, 22] = npy(b.alpha)[bsdf_id]
    tri[:t_cnt, 23] = npy(b.int_ior)[bsdf_id]
    tri[:t_cnt, 24] = npy(b.ext_ior)[bsdf_id]
    tri[:t_cnt, 25] = npy(b.ks)[bsdf_id]
    tri[:t_cnt, 26:29] = npy(b.kd)[bsdf_id]
    alb_tex = npy(b.albedo_tex)[bsdf_id]
    tex_val = npy(scene.textures.value)
    tri[:t_cnt, 29:32] = np.where((alb_tex >= 0)[:, None], tex_val[np.maximum(alb_tex, 0)], 1.0)
    tri[:t_cnt, 32] = npy(scene.shapes.emitter)[shape_id].astype(np.float32)
    tri[:t_cnt, 33:43] = npy(b.disney)[bsdf_id]

    # camera pack
    cam = scene.camera
    sf = np.zeros(SF_COLS, np.float32)
    sf[0:16] = npy(sample_to_camera_matrix(cam, config.width, config.height)).reshape(-1)
    sf[16:32] = npy(cam.to_world).astype(np.float32).reshape(-1)
    sf[32] = float(cam.lens_radius)
    sf[33] = float(cam.focal_distance)
    sf[34] = float(cam.near_clip)
    sf[35] = float(cam.far_clip)
    sf[36] = 1.0 / config.width
    sf[37] = 1.0 / config.height

    if t_cnt > VPU_MAX_TRIS:
        packed, leaf = _walk_tables(g, tri[:t_cnt])
    else:
        packed, leaf = np.zeros((1, 8), np.float32), np.zeros((1, 40), np.float32)

    host = {"tri": tri, "et": mt["et"], "em_rows": mt["em_rows"], "env": mt["env"],
            "sph": mt["sph"], "scal_f": sf, "packed": packed, "leaf": leaf}
    tables = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}
    meta = {
        "t_cnt": t_cnt,
        "te_cnt": te_cnt,
        "te_pad": int(mt["et"].shape[0]),
        "use_dof": float(sf[32]) > 1e-4,
        "n_sph": int(g.sph_center.shape[0]),
        "n_emitters": int(mt["em_rows"].shape[0]),
        "n_nodes": int(packed.shape[0]),
    }
    return tables, meta


def _walk_tables(g, rows):
    """(packed, leaf) of the medium branch: the scene's LBVH or one built
    from the rows' v0 | e1 | e2. Raises unless every leaf slot's v0 | e1 |
    e2 equals its triangle's row bit for bit (the walk's t, u, v would
    otherwise differ from the row's)."""
    if g.bvh is not None:
        packed, leaf = (x.detach().cpu().numpy() for x in (g.bvh.packed, g.bvh.leaf))
    else:
        packed, leaf = bvh.build_bvh_tables_from_edges(rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
    slots = leaf.reshape(-1, bvh.LEAF_SIZE, 10)
    ids = slots[..., 9].copy().view(np.int32)
    real = ids >= 0
    if (np.sort(ids[real]) != np.arange(rows.shape[0])).any():
        raise ValueError("the LBVH's leaves do not hold every triangle once")
    if (slots[real][:, 0:9].view(np.int32) != rows[ids[real], 0:9].view(np.int32)).any():
        raise ValueError("the LBVH's leaf slots differ from the triangle rows' v0 | e1 | e2")
    return np.ascontiguousarray(packed), np.ascontiguousarray(leaf)


# ---------------------------------------------------------------------------
# per-lane building blocks of the plain version
# ---------------------------------------------------------------------------


def _fis_jitter2(u1, u2, rfilter: str):
    """(u1,u2) uniforms → (jx, jy) jitter distributed as the reconstruction
    filter (filter importance sampling: each sample lands on its own pixel
    with weight 1).

    box      → identity.
    tent     → exact inverse CDF of (1−|x|) per component.
    gaussian → Box–Muller pair at the filter's σ=0.5, clamped to the r=2
               support (rfilter.cpp:34-52).
    """
    if rfilter == "box":
        return u1, u2

    def tent_inv(u):
        lo = torch.sqrt(torch.clamp(2.0 * u, min=0.0)) - 1.0
        hi = 1.0 - torch.sqrt(torch.clamp(2.0 - 2.0 * u, min=0.0))
        return where(u < 0.5, lo, hi)

    if rfilter == "tent":
        return tent_inv(u1) + 0.5, tent_inv(u2) + 0.5
    if rfilter == "gaussian":
        sigma, radius = 0.5, 2.0
        r_ = sigma * torch.sqrt(-2.0 * torch.log(torch.clamp(1.0 - u1, min=1e-12)))
        th = 2.0 * PI * u2
        jx = torch.clamp(r_ * torch.cos(th), -radius, radius) + 0.5
        jy = torch.clamp(r_ * torch.sin(th), -radius, radius) + 0.5
        return jx, jy
    raise ValueError(f"filter '{rfilter}' cannot be importance-sampled")


def _seed_sampler(pix, sample, seed) -> rng.Pcg32State:
    """render/sampler.make_sampler: initstate = tea(pix, sample ^ seed), initseq = pix."""
    h = rng.tea(pix, rng.u32(sample) ^ (seed & rng.M32))
    zeros = torch.zeros_like(h)
    return rng.pcg32_seed(zeros, h, zeros, pix)


def _camera_ray(sf, px, py, st, *, rfilter, use_dof):
    """PerspectiveCamera::sampleRay from the scalar pack `sf` (1-D, SF_COLS).

    Draws jitter (2) + aperture (2) from `st`; jitter goes through the
    filter inverse CDF. Returns (st, o, d, mint, maxt)."""
    st, (uj1, uj2) = draw2(st)
    jx, jy = _fis_jitter2(uj1, uj2, rfilter)
    st, (a1, a2) = draw2(st)

    x = (px + jx) * sf[36]
    y = (py + jy) * sf[37]
    m = lambda i, j: sf[i * 4 + j]
    nx = m(0, 0) * x + m(0, 1) * y + m(0, 3)
    ny = m(1, 0) * x + m(1, 1) * y + m(1, 3)
    nz = m(2, 0) * x + m(2, 1) * y + m(2, 3)
    wq = m(3, 0) * x + m(3, 1) * y + m(3, 3)
    inv_w = 1.0 / wq
    dl = vnormalize((nx * inv_w, ny * inv_w, nz * inv_w))

    if use_dof:
        r_ = sf[32] * torch.sqrt(torch.clamp(a1, min=0.0))
        th = 2.0 * PI * a2
        p_lens = (r_ * torch.cos(th), r_ * torch.sin(th), torch.zeros_like(r_))
        ft = sf[33] / dl[2]
        d_cam = vnormalize(vsub(vscale(dl, ft), p_lens))
        o_cam = p_lens
    else:
        d_cam = dl
        o_cam = (torch.zeros_like(dl[0]),) * 3

    tm = lambda i, j: sf[16 + i * 4 + j]
    o = tuple(tm(r, 0) * o_cam[0] + tm(r, 1) * o_cam[1] + tm(r, 2) * o_cam[2] + tm(r, 3)
              for r in range(3))
    d = tuple(tm(r, 0) * d_cam[0] + tm(r, 1) * d_cam[1] + tm(r, 2) * d_cam[2]
              for r in range(3))
    inv_z = 1.0 / dl[2]
    return st, o, d, sf[34] * inv_z, sf[35] * inv_z


def _isect(tri, t_cnt, o, d, mint, maxt, so, sd, s_maxt):
    """Fused sweep of the small branch (and the function the medium branch's
    walk computes): closest hit of (o,d) in [mint, maxt) + any hit of the
    shadow segment (so, sd, [EPS, s_maxt)), as chunked [N, chunk] sweeps
    over v0 | e1 | e2 of the triangle rows (`isect.mt_sweep_ref`,
    `isect.mt_any_ref`). The winner is the lowest-index minimum of t, as in
    the kernel's in-order sweep.

    Returns (t, u, v, hit mask, winner's triangle row [N, TR_COLS] — zeros
    on a miss —, occluded)."""
    v0, e1, e2 = tri[:t_cnt, 0:3], tri[:t_cnt, 3:6], tri[:t_cnt, 6:9]
    best_j, best_t, best_u, best_v = isect.mt_sweep_ref(
        torch.stack(o, -1), torch.stack(d, -1), mint, maxt, v0, e1, e2)
    occl = isect.mt_any_ref(torch.stack(so, -1), torch.stack(sd, -1),
                            torch.full_like(s_maxt, EPS), s_maxt, v0, e1, e2)
    hit = best_j >= 0
    attrs = where(hit[:, None], tri[best_j.clamp(min=0).long()], 0.0)
    return best_t, best_u, best_v, hit, attrs, occl


def _walk_isect(tri, packed, leaf, o, d, mint, maxt, so, sd, s_maxt, live, sh_pend):
    """The medium branch's intersections, as its kernel finds them: the LBVH
    walk's closest hit of (o, d) in [mint, maxt) on the `live` lanes, with
    exact ties in t going to the smaller id (the lowest-index minimum, as
    `_isect` takes it), and the any hit of the shadow segment (so, sd,
    [EPS, s_maxt)) on the lanes with one pending (`sh_pend`). Other lanes
    get a miss. Both walks run as one `traverse_walk_ref` call over the
    closest-hit rays followed by the shadow rays. Returns what `_isect`
    returns."""
    kc, ks = live.nonzero().squeeze(1), sh_pend.nonzero().squeeze(1)
    nc = kc.numel()
    best_id = torch.full_like(mint, -1, dtype=torch.int32)
    best_t, best_u, best_v = maxt.clone(), torch.zeros_like(mint), torch.zeros_like(mint)
    occl = torch.zeros_like(live)
    if nc + ks.numel():
        ids, t, u, v = bvh.traverse_walk_ref(
            packed, leaf,
            torch.cat([torch.stack(o, -1)[kc], torch.stack(so, -1)[ks]]),
            torch.cat([torch.stack(d, -1)[kc], torch.stack(sd, -1)[ks]]),
            torch.cat([mint[kc], torch.full_like(s_maxt[ks], EPS)]),
            torch.cat([maxt[kc], s_maxt[ks]]),
            any_hit=torch.arange(nc + ks.numel(), device=mint.device) >= nc, lowest_id=True)
        best_id[kc], best_t[kc], best_u[kc], best_v[kc] = ids[:nc], t[:nc], u[:nc], v[:nc]
        occl[ks] = ids[nc:] >= 0
    hit = best_id >= 0
    attrs = where(hit[:, None], tri[best_id.clamp(min=0).long()], 0.0)
    return best_t, best_u, best_v, hit, attrs, occl


def _nee_sample_smem(em, et, env, n_emitters, te_cnt, p_hit, st, medium=False):
    """NEE sample: emitter pick by the pick CDF, emissive triangle by its
    area CDF (dpdf sampleReuse), then area / point / spot / directional /
    constant-env sampling. Draws pick 1 + 3.

    `et` is the padded table. The small branch scans its first `te_cnt`
    rows; `medium` takes the medium branch's pick (`mega.py: nee_sample`):
    the first of all rows that qualifies, else the last row, and no
    `found` term in `ok_area`."""
    st, u_pick = draw1(st)
    st, (ua, ub, _uc) = draw3(st)
    zero = torch.zeros_like(u_pick)
    em_l = em.tolist()

    eid = torch.zeros_like(u_pick, dtype=torch.int64)
    for e in range(n_emitters - 1):
        eid = eid + (em_l[e][12] <= u_pick).to(torch.int64)
    (etype,) = emitter_lookup(em, n_emitters, eid, [0])

    # ---- area: first et row of this emitter with cdf > ua
    n_rows = et.shape[0] if medium else max(te_cnt, 1)
    sel = torch.full_like(eid, -1)
    for k, row in enumerate(et[:n_rows].tolist()):
        m = (sel < 0) & (eid == int(row[19])) & (row[18] > ua)
        sel = where(m, k, sel)
    if medium:
        sel = where(sel < 0, n_rows - 1, sel)
    found = sel >= 0
    R = where(found[:, None], et[sel.clamp(min=0)], 0.0)
    tv0, te1, te2 = (R[:, 0], R[:, 1], R[:, 2]), (R[:, 3], R[:, 4], R[:, 5]), (R[:, 6], R[:, 7], R[:, 8])
    tn0, td1, td2 = (R[:, 9], R[:, 10], R[:, 11]), (R[:, 12], R[:, 13], R[:, 14]), (R[:, 15], R[:, 16], R[:, 17])
    cdf_hi, cdf_lo = R[:, 18], R[:, 20]

    ua_re = torch.clamp((ua - cdf_lo) / torch.clamp(cdf_hi - cdf_lo, min=1e-12), 0.0, 1.0 - 1e-7)
    su = torch.sqrt(torch.clamp(ua_re, min=0.0))
    b1 = ub * su
    b2 = 1.0 - (1.0 - su) - b1
    p_surf = vadd(tv0, vadd(vscale(te1, b1), vscale(te2, b2)))
    n_surf = vnormalize(vadd(tn0, vadd(vscale(td1, b1), vscale(td2, b2))))
    to_p = vsub(p_surf, p_hit)
    dist2 = torch.clamp(vdot(to_p, to_p), min=1e-20)
    dist = torch.sqrt(dist2)
    wi_area = vscale(to_p, 1.0 / dist)
    cos_em = vdot(n_surf, vneg(wi_area))
    area_tot, rad_r, rad_g, rad_b = emitter_lookup(em, n_emitters, eid, [10, 1, 2, 3])
    inv_area = 1.0 / torch.clamp(area_tot, min=1e-20)
    pdf_area = inv_area * dist2 / torch.clamp(torch.abs(cos_em), min=1e-12)
    ok_area = (cos_em > 0.0) & (pdf_area > EPS) & found
    inv_pdf = where(ok_area, 1.0 / torch.clamp(pdf_area, min=1e-12), 0.0)
    val_area = (rad_r * inv_pdf, rad_g * inv_pdf, rad_b * inv_pdf)

    # ---- point
    px_, py_, pz_ = emitter_lookup(em, n_emitters, eid, [4, 5, 6])
    to_l = (px_ - p_hit[0], py_ - p_hit[1], pz_ - p_hit[2])
    d2pt = torch.clamp(vdot(to_l, to_l), min=1e-20)
    dpt = torch.sqrt(d2pt)
    wi_pt = vscale(to_l, 1.0 / dpt)
    val_pt = (rad_r / d2pt, rad_g / d2pt, rad_b / d2pt)

    # ---- spot (spotlight.cpp:54-74): cone intensity power/2π, delta⁴ ramp
    dx_e, dy_e, dz_e, c_start, c_end, ang_r = emitter_lookup(
        em, n_emitters, eid, [13, 14, 15, 16, 17, 18])
    pw_r, pw_g, pw_b = emitter_lookup(em, n_emitters, eid, [7, 8, 9])
    cos_theta = -(wi_pt[0] * dx_e + wi_pt[1] * dy_e + wi_pt[2] * dz_e)
    delta = (cos_theta - c_end) / torch.clamp(c_start - c_end, min=1e-12)
    r1 = torch.clamp(delta, 0.0, 1.0)
    r2 = r1 * r1
    falloff = where(cos_theta < c_end, 0.0, where(cos_theta >= c_start, 1.0, r2 * r2))
    i_norm = falloff / (2.0 * PI * torch.clamp(1.0 - 0.5 * (c_end + c_start), min=1e-12) * d2pt)
    val_spot = (pw_r * i_norm, pw_g * i_norm, pw_b * i_norm)

    # ---- directional (directionalLight.cpp:90-136): uniform cap around −direction
    cos_cap = torch.cos(ang_r)
    dir_t = vnormalize((dx_e, dy_e, dz_e))
    sD, tD = onb(dir_t)
    zc = ua * (1.0 - cos_cap) + cos_cap
    rc = safe_sqrt(1.0 - zc * zc)
    thc = 2.0 * PI * ub
    wi_dir = vneg(to_world(sD, tD, dir_t, (rc * torch.cos(thc), rc * torch.sin(thc), zc)))
    pdf_dir = 1.0 / torch.clamp(2.0 * PI * (1.0 - cos_cap), min=1e-12)
    inv_pd = 1.0 / pdf_dir
    val_dir = (rad_r * inv_pd, rad_g * inv_pd, rad_b * inv_pd)

    # ---- constant envmap: uniform sphere, pdf 1/4π
    z = 2.0 * ua - 1.0
    r_ = safe_sqrt(1.0 - z * z)
    sig = 2.0 * PI * ub
    wi_env = (r_ * torch.cos(sig), r_ * torch.sin(sig), z)
    fourpi = 4.0 * PI
    val_env = tuple((zero + env[c]) * fourpi for c in range(3))  # float32 product

    is_area = etype == float(EM_AREA)
    is_pt = etype == float(EM_POINT)
    is_spot = etype == float(EM_SPOT)
    is_dir = etype == float(EM_DIRECTIONAL)
    is_delta = is_pt | is_spot
    wi = vwhere(is_area, wi_area, vwhere(is_delta, wi_pt, vwhere(is_dir, wi_dir, wi_env)))
    value = tuple(
        where(is_area, val_area[c], where(is_pt, val_pt[c], where(
            is_spot, val_spot[c], where(is_dir, val_dir[c], val_env[c]))))
        for c in range(3)
    )
    pdf_sa = where(is_area, where(ok_area, pdf_area, 0.0),
                   where(is_delta, 1.0, where(is_dir, pdf_dir, 1.0 / fourpi)))
    shadow_dist = where(is_area | is_delta, where(is_area, dist, dpt) - EPS, BIG)
    return st, {"wi": wi, "value": value, "pdf_sa": pdf_sa, "shadow_dist": shadow_dist}


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def pathk_trace_ref(tables, meta, config, *, n_pix, spp0, n_spp, pix0=0):
    """Plain torch version of the path kernel over pixels [pix0, pix0 + n_pix)
    of the image (column c holds pixel pix0 + c).

    Every lane runs the kernel's per-pixel loop; lanes that have finished
    (no active path, no pending shadow ray) stay in the batch but add
    nothing, and the loop ends when no lane has work or after
    `n_spp·max_depth + 2` iterations. Returns float32 [16, n_pix].
    """
    mis = config.integrator == "path_mis"
    n_lights = max(config.n_emitters, 1)
    max_depth = config.max_depth
    tri, et, em, sph = tables["tri"], tables["et"], tables["em_rows"], tables["sph"]
    env = tables["env"].tolist()
    sf = tables["scal_f"].tolist()
    t_cnt, te_cnt, n_em = meta["t_cnt"], meta["te_cnt"], meta["n_emitters"]
    medium = t_cnt > VPU_MAX_TRIS
    dev = em.device
    f32 = torch.float32

    pix = torch.arange(pix0, pix0 + n_pix, dtype=torch.int64, device=dev)
    px = (pix % config.width).to(f32)
    py = (pix // config.width).to(f32)
    zero = torch.zeros(n_pix, dtype=f32, device=dev)
    one = torch.ones_like(zero)
    false = torch.zeros(n_pix, dtype=torch.bool, device=dev)

    def cam_gen(sample_idx):
        st_seed = _seed_sampler(pix, spp0 + sample_idx, config.seed)
        return _camera_ray(sf, px, py, st_seed, rfilter=config.rfilter, use_dof=meta["use_dof"])

    st, o, d, mint, maxt = cam_gen(torch.zeros_like(pix))
    depth, active, started = zero, ~false, torch.ones_like(pix)
    tr, tg, tb = one, one, one
    pdf_prev, prev_disc = zero, false
    sh_o, sh_d, sh_dist, sh_pend = (zero, zero, zero), (zero, zero, one), -one, false
    sh_c = (zero, zero, zero)
    aL, aA, aN = (zero, zero, zero), (zero, zero, zero), (zero, zero, zero)
    n_done, iters = zero, zero
    live = ~false
    has_env = env[3] > 0.0

    it = 0
    while it < n_spp * max_depth + 2 and bool(live.any()):
        iters = iters + live.to(f32)
        was = active
        first = depth < 0.5

        # ---- 1. closest hit (current ray) + any hit (shadow ray): the LBVH
        # walk in the medium branch, the fused sweep in the small one
        if medium:
            t_tri, u, v, tri_valid, A, occ_tri = _walk_isect(
                tri, tables["packed"], tables["leaf"], o, d, mint, maxt, sh_o, sh_d, sh_dist,
                live, sh_pend)
        else:
            t_tri, u, v, tri_valid, A, occ_tri = _isect(
                tri, t_cnt, o, d, mint, maxt, sh_o, sh_d, sh_dist)
        P = {"btype": A[:, 21], "alpha": A[:, 22], "int_ior": A[:, 23],
             "ext_ior": A[:, 24], "ks": A[:, 25],
             "kd": (A[:, 26], A[:, 27], A[:, 28]),
             "albedo": (A[:, 29], A[:, 30], A[:, 31]),
             "disney": tuple(A[:, 33 + k] for k in range(10))}
        _, s_sid = sphere_hit(sph, sh_o, sh_d, torch.full_like(mint, EPS), sh_dist)
        occ = occ_tri | (s_sid >= 0)

        # ---- 2. resolve the pending NEE shadow ray from the last iteration
        vis = sh_pend & ~occ
        aL = tuple(aL[c] + where(vis, sh_c[c], 0.0) for c in range(3))
        sh_pend = false

        # ---- 3. a sphere hit must beat the best triangle
        t_sph, sid = sphere_hit(sph, o, d, mint, t_tri)
        sphere_wins = sid >= 0
        t_best = where(sphere_wins, t_sph, t_tri)
        valid = tri_valid | sphere_wins
        ns = vnormalize(tuple(A[:, 12 + c] + u * A[:, 15 + c] + v * A[:, 18 + c]
                              for c in range(3)))
        p_hit = vadd(o, vscale(d, where(valid, t_best, 1.0)))
        P, ns, _ = sphere_params(sph, sid, P, ns, p_hit)
        sf_, tf_ = onb(ns)
        em_id = where(tri_valid & ~sphere_wins, A[:, 32].to(torch.int64), -1)

        # ---- 4. miss → constant envmap.
        # The kernel's NEE samples a constant envmap uniformly over the
        # sphere, so this MIS weight uses pdf 1/4π/n_lights; the JAX
        # package's XLA path importance-samples the envmap image and
        # weights with that pdf instead. Both are unbiased, so env-lit films
        # agree with the XLA film only in expectation: parity tests compare
        # with the JAX path-kernel film.
        miss = active & ~valid
        if mis:
            pdf_env_dir = 1.0 / (4.0 * PI) / n_lights if has_env else 0.0
            denom_env = pdf_prev + pdf_env_dir
            w_env = where(first | prev_disc, 1.0, where(
                denom_env > EPS, pdf_prev / torch.clamp(denom_env, min=1e-20), 1.0))
        else:
            w_env = one
        me = where(miss, w_env, 0.0)
        aL = (aL[0] + me * tr * env[0], aL[1] + me * tg * env[1], aL[2] + me * tb * env[2])
        active = active & valid

        # ---- 5. first-hit AOVs
        firstm = first & valid
        aA = tuple(aA[c] + where(firstm, P["albedo"][c], 0.0) for c in range(3))
        aN = tuple(aN[c] + where(firstm, ns[c], 0.0) for c in range(3))

        # ---- 6. emitter hit (MATS side)
        hit_em = active & (em_id >= 0)
        er, eg, eb = emitter_lookup(em, n_em, em_id, [1, 2, 3])
        add_em = hit_em & (vdot(ns, vneg(d)) >= 0.0)
        if mis:
            (area_tot,) = emitter_lookup(em, n_em, em_id, [10])
            cos_e = vdot(ns, vneg(vnormalize(d)))
            to_hit = vsub(p_hit, o)
            dist2 = vdot(to_hit, to_hit)
            pdf_ems_here = where(
                hit_em & (cos_e > 0.0),
                (1.0 / torch.clamp(area_tot, min=1e-20)) * dist2
                / torch.clamp(torch.abs(cos_e), min=1e-12) / n_lights,
                0.0)
            denom = pdf_prev + pdf_ems_here
            w_mats = where(first | prev_disc, 1.0, where(
                denom > EPS, pdf_prev / torch.clamp(denom, min=1e-20), 1.0))
        else:
            w_mats = one
        ae = where(add_em, w_mats, 0.0)
        aL = (aL[0] + ae * tr * er, aL[1] + ae * tg * eg, aL[2] + ae * tb * eb)

        # ---- 7. Russian roulette (path_mis.cpp:58-71 / raygen.cpp:119-127)
        st, u_rr = draw1(st)
        tmax_c = torch.maximum(tr, torch.maximum(tg, tb))
        if mis:
            succ = torch.clamp(tmax_c, EPS, 0.99)
            die = (u_rr > succ) & active
            inv_s = 1.0 / succ
            scale_on = active
        else:
            succ = torch.clamp(tmax_c, max=0.99)
            rr_on = depth >= 2.5
            die = rr_on & (u_rr > succ) & active
            inv_s = 1.0 / torch.clamp(succ, min=1e-12)
            scale_on = rr_on & active
        tr = where(scale_on, tr * inv_s, tr)
        tg = where(scale_on, tg * inv_s, tg)
        tb = where(scale_on, tb * inv_s, tb)
        active = active & ~die

        wi_l = to_local(sf_, tf_, ns, vneg(vnormalize(d)))
        if mis:
            # ---- 8. EMS: sample NEE, queue the shadow ray for the next sweep
            st, nr = _nee_sample_smem(em, et, env, n_em, te_cnt, p_hit, st, medium)
            wi_w = nr["wi"]
            wi_light_l = to_local(sf_, tf_, ns, wi_w)
            nz_val = ((torch.abs(nr["value"][0]) > EPS) | (torch.abs(nr["value"][1]) > EPS)
                      | (torch.abs(nr["value"][2]) > EPS))
            cand = nz_val & valid & active
            f_l = bsdf_eval_c(P, wi_l, wi_light_l)
            cos_l = vdot(wi_w, ns)
            pdf_mat_at = where(cand, bsdf_pdf_c(P, wi_l, wi_light_l), 0.0)
            pdf_ems = where(cand, nr["pdf_sa"] / n_lights, 0.0)
            contrib = tuple(where(cand, nr["value"][c] * cos_l * f_l[c] * n_lights, 0.0)
                            for c in range(3))
            w_ems = where(pdf_ems + pdf_mat_at > EPS,
                          pdf_ems / torch.clamp(pdf_ems + pdf_mat_at, min=1e-20), 0.0)
            # ---- 9. MATS sample
            st, (um1, um2) = draw2(st)
            wo_l, bw, bpdf, bdisc = bsdf_sample_c(P, wi_l, um1, um2)
            amask = where(cand, where(bdisc, 0.0, w_ems), 0.0)
            sh_pend = ((amask * contrib[0] != 0.0) | (amask * contrib[1] != 0.0)
                       | (amask * contrib[2] != 0.0))
            sh_c = (amask * tr * contrib[0], amask * tg * contrib[1], amask * tb * contrib[2])
            sh_o, sh_d, sh_dist = p_hit, wi_w, nr["shadow_dist"]
            pdf_prev_new, prev_disc_new = bpdf, bdisc
        else:
            st, (um1, um2) = draw2(st)
            wo_l, bw, bpdf, bdisc = bsdf_sample_c(P, wi_l, um1, um2)
            sh_c = (zero, zero, zero)
            sh_dist = -one
            pdf_prev_new, prev_disc_new = pdf_prev, prev_disc

        tr = where(active, tr * bw[0], tr)
        tg = where(active, tg * bw[1], tg)
        tb = where(active, tb * bw[2], tb)
        active = active & ((torch.abs(tr) > 1e-12) | (torch.abs(tg) > 1e-12)
                           | (torch.abs(tb) > 1e-12))
        wo_w = to_world(sf_, tf_, ns, wo_l)
        o = vwhere(active, p_hit, o)
        d = vwhere(active, wo_w, d)
        mint = where(active, EPS, mint)
        maxt = where(active, BIG, maxt)
        depth = depth + 1.0

        # ---- 10. termination + regeneration
        end = was & (~active | (depth > max_depth - 0.5))
        n_done = n_done + end.to(f32)
        regen = end & (started < n_spp)
        st_new, o2, d2, mint2, maxt2 = cam_gen(started)
        o = vwhere(regen, o2, o)
        d = vwhere(regen, d2, d)
        mint = where(regen, mint2, mint)
        maxt = where(regen, maxt2, maxt)
        st = rng.Pcg32State(*(where(regen, a, b) for a, b in zip(st_new, st)))
        started = started + regen.to(torch.int64)
        depth = where(regen, 0.0, depth)
        tr, tg, tb = where(regen, 1.0, tr), where(regen, 1.0, tg), where(regen, 1.0, tb)
        pdf_prev = where(regen, 0.0, pdf_prev_new)
        prev_disc = prev_disc_new & ~regen
        active = (active & ~end) | regen
        live = active | sh_pend
        it += 1

    return torch.stack([*aL, n_done, *aA, *aN, iters] + [zero] * 5)


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

_TABLE_COLS = {"tri": TR_COLS, "et": mega.ET_COLS, "em_rows": mega.ER_COLS,
               "sph": mega.SPH_COLS, "packed": 8, "leaf": 40}


def _check_tables(tables, meta, device):
    for name, t in tables.items():
        if t.device != device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"table '{name}' must be a contiguous float32 tensor on {device}")
    for name, cols in _TABLE_COLS.items():
        if tables[name].dim() != 2 or tables[name].shape[1] != cols:
            raise ValueError(f"table '{name}' must be [rows, {cols}], got {tuple(tables[name].shape)}")
    if tables["scal_f"].shape != (SF_COLS,) or tables["env"].shape != (4,):
        raise ValueError("scal_f must be [40] and env [4]")
    t_cnt = meta["t_cnt"]
    if not 0 < t_cnt <= min(mega.MAX_MXU_TRIS, tables["tri"].shape[0]):
        raise ValueError(f"t_cnt {t_cnt} outside [1, {mega.MAX_MXU_TRIS}] or the table")
    if not meta["te_cnt"] <= tables["et"].shape[0] == meta["te_pad"]:
        raise ValueError("et must hold te_pad rows, te_cnt of them real")
    if meta["n_emitters"] > tables["em_rows"].shape[0]:
        raise ValueError("n_emitters exceeds the emitter table")
    if meta["n_nodes"] != tables["packed"].shape[0] or any(
            tables[k].data_ptr() % 16 for k in ("packed", "leaf")):
        raise ValueError("packed must hold n_nodes rows, and packed and leaf must be "
                         "16-byte aligned")
    if t_cnt > VPU_MAX_TRIS and tables["leaf"].shape[0] * bvh.LEAF_SIZE < t_cnt:
        raise ValueError("the medium branch needs the scene's LBVH: leaf holds "
                         f"{tables['leaf'].shape[0]} rows for {t_cnt} triangles")


def _check_sizes(config, n_pix, spp0, n_spp, pix0=0):
    """The C interface takes 32-bit ints; ctypes would truncate silently."""
    limit = 2**31 - 1
    if not (0 <= n_pix and 0 <= pix0 and pix0 + n_pix <= limit and 0 < config.width <= limit
            and 0 <= n_spp and n_spp * config.max_depth + 2 <= limit and 0 <= spp0 <= limit
            and 0 < config.max_depth and -2**31 <= config.seed <= limit):
        raise ValueError(f"pathk_trace sizes out of range: pix0={pix0}, n_pix={n_pix}, "
                         f"width={config.width}, spp0={spp0}, n_spp={n_spp}, "
                         f"max_depth={config.max_depth}, seed={config.seed}")


def pathk_trace(tables, meta, config, *, n_pix, spp0, n_spp, pix0=0):
    """Trace `n_spp` samples (from sample index `spp0`) for pixels
    [pix0, pix0 + n_pix) of the image: column c of the result holds pixel
    pix0 + c, bit for bit the column pix0 + c of a launch over the whole
    image (the JAX kernel's `base_block`, here any run of pixels).

    CPU tables run the plain version; CUDA tables launch a kernel of
    `csrc/pathk.cu` on the current stream (`pathk_kernel<MIS>` up to
    VPU_MAX_TRIS triangles, `pathk_staged_kernel<MIS>` above), or raise. Returns float32
    [16, n_pix] on the tables' device.
    """
    global LAUNCHES
    device = tables["em_rows"].device
    if device.type == "cpu":
        return pathk_trace_ref(tables, meta, config, n_pix=n_pix, spp0=spp0, n_spp=n_spp,
                               pix0=pix0)
    if device.type != "cuda":
        raise ValueError(f"pathk_trace runs on cpu or cuda tensors, got {device}")
    _check_tables(tables, meta, device)
    _check_sizes(config, n_pix, spp0, n_spp, pix0)
    if config.rfilter not in FILTERS:
        raise ValueError(f"filter '{config.rfilter}' cannot be importance-sampled")
    from optix_renderer_tpu_torch.ops.cuda import _build

    lib = _build.load()
    out = torch.empty((OUT_ROWS, n_pix), dtype=torch.float32, device=device)
    # the counter from which the kernel's warps take their pixels, 0 at launch
    # (held here until the launch)
    next_pix = torch.zeros(1, dtype=torch.int32, device=device)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.pathk_trace_launch(
            ptr(out), ptr(tables["scal_f"]), ptr(tables["em_rows"]), ptr(tables["env"]),
            ptr(tables["sph"]), tables["sph"].shape[0],
            ptr(tables["tri"]), meta["t_cnt"],
            ptr(tables["packed"]), meta["n_nodes"], ptr(tables["leaf"]),
            ptr(tables["et"]), meta["te_cnt"], meta["te_pad"],
            pix0, n_pix, config.width, spp0, config.seed, n_spp, config.max_depth,
            meta["n_emitters"], max(config.n_emitters, 1),
            int(config.integrator == "path_mis"), FILTERS[config.rfilter],
            int(meta["use_dof"]), ptr(next_pix), ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"pathk kernel launch failed: cudaError {rc} ({_build.error_string(rc)})")
    LAUNCHES += 1
    return out


def last_launch() -> dict[str, int]:
    """The grid of the last `pathk_trace` launch in this process: its
    branch, blocks, threads per block, resident blocks per SM (the
    occupancy the launcher sized the persistent grid by) and dynamic shared
    memory in bytes."""
    from optix_renderer_tpu_torch.ops.cuda import _build

    vals = [ctypes.c_int(0) for _ in range(5)]
    _build.load().pathk_last_launch(*(ctypes.byref(v) for v in vals))
    keys = ("medium", "blocks", "threads", "blocks_per_sm", "smem_bytes")
    return {k: v.value for k, v in zip(keys, vals)}
