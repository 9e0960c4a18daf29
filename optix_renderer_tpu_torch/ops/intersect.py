"""Ray–scene intersection of the general path: triangles through the kernels,
analytic spheres in plain torch.

Counterpart of `optix_renderer_tpu/ops/intersect.py` (`intersect`,
`occluded`, `make_interaction`), dispatched as the JAX package's CPU path
is: fewer than `MIN_TRIS_FOR_BVH` triangles go to the brute-force sweep
(`ops/cuda/isect.py: isect_brute`), the rest to the LBVH walk (`isect_bvh`).
On CUDA tensors those launch the kernels of `csrc/isect.cu`; on the CPU
their plain versions run. The kernels only pick the winning triangle, on
detached inputs (the JAX detach-and-replay contract); (t, u, v) are
recomputed from the live rays and triangle arrays by `ops/bvh.py:
replay_tri`, through which autograd flows. Spheres use the stable
quadratic (sphere.cpp:67-124), over all spheres in torch up to 64 of
them; from `MIN_SPHS_FOR_BVH` = 65 the spheres' LBVH picks the winner
(`isect_spheres`, on detached inputs) and `ops/bvh.py: replay_sphere`
recomputes its t live (intersect.py:196-212 of the JAX package).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from optix_renderer_tpu_torch.core.math import PI, Ray, cross, dot, normalize
from optix_renderer_tpu_torch.ops.bvh import (
    BIG,
    MIN_SPHS_FOR_BVH,
    MIN_TRIS_FOR_BVH,
    replay_sphere,
    replay_tri,
)
from optix_renderer_tpu_torch.ops.cuda import isect
from optix_renderer_tpu_torch.scene.data import Geometry

# primitive kinds in hit records
PRIM_NONE = 0
PRIM_TRI = 1
PRIM_SPHERE = 2


class Hit(NamedTuple):
    """Nearest-hit record per ray (pre-shading): all fields `[N]`."""

    t: torch.Tensor
    prim_kind: torch.Tensor  # int32: PRIM_NONE / TRI / SPHERE
    prim_id: torch.Tensor  # int32 index into the triangle or sphere table
    u: torch.Tensor  # triangle barycentric u
    v: torch.Tensor


class Interaction(NamedTuple):
    """Shading-ready surface interaction (reference Intersection, shape.h:37-99)."""

    valid: torch.Tensor  # [N] bool
    t: torch.Tensor
    p: torch.Tensor  # [N,3]
    n_s: torch.Tensor  # shading normal
    n_g: torch.Tensor  # geometric normal
    uv: torch.Tensor  # [N,2]
    tang: torch.Tensor  # [N,4] UV tangent dp/du + handedness w (zero → no UV chart)
    shape: torch.Tensor  # [N] int32 shape id (−1 on a miss)
    prim_kind: torch.Tensor
    prim_id: torch.Tensor


def _ray_spheres(o, d, center, radius):
    """Stable quadratic roots (sphere.cpp:67-124): o, d [N,3]; center [S,3];
    radius [S] → near t, far t [N,S] and the discriminant mask."""
    oc = o[:, None, :] - center[None, :, :]
    a = dot(d, d)[:, None]
    b = 2.0 * dot(oc, d[:, None, :])
    c = dot(oc, oc) - (radius * radius)[None, :]
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    q = -0.5 * (b + torch.sign(b) * sq)
    t0 = q / a
    t1 = c / torch.where(torch.abs(q) > 1e-20, q, 1e-20)
    return torch.minimum(t0, t1), torch.maximum(t0, t1), ok


def _triangle_winner(geom: Geometry, ray: Ray, cutoff, any_hit: bool):
    """Winning triangle id [N] (−1 on a miss) from the kernel of this
    scene's size. The brute-force sweep always finds the closest hit, which
    is also a valid any-hit answer, as in the JAX package.

    The pick is a discrete decision and runs on detached inputs (the JAX
    package's `stop_gradient` before its kernels): the kernels take raw
    pointers, and the plain versions write into their outputs in place,
    which autograd must not follow. `intersect` replays the winner live."""
    o, d, mint, cutoff = (x.detach() for x in (ray.o, ray.d, ray.mint, cutoff))
    n_tris = geom.tri_v0.shape[0]
    if n_tris < MIN_TRIS_FOR_BVH:
        ids, *_ = isect.isect_brute(geom.tri_table.detach(), o, d, mint, cutoff)
        return ids
    if geom.bvh is None:
        raise ValueError(f"{n_tris} triangles need the LBVH tables (scene.data.Bvh); "
                         "build the scene with scene.build or scene_from_numpy")
    ids, *_ = isect.isect_bvh(geom.bvh.detach(), o, d, mint, cutoff, any_hit=any_hit)
    return ids


def intersect(geom: Geometry, ray: Ray, any_hit: bool = False) -> Hit:
    """Closest-hit (or, with `any_hit`, some hit) of a ray wavefront."""
    n = ray.o.shape[0]
    dev = ray.o.device
    best_t = torch.where(torch.isinf(ray.maxt), BIG, ray.maxt)
    kind = torch.zeros(n, dtype=torch.int32, device=dev)
    prim = torch.zeros(n, dtype=torch.int32, device=dev)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)

    if geom.tri_v0.shape[0] > 0:
        ids = _triangle_winner(geom, ray, best_t, any_hit)
        found = ids >= 0
        gid = torch.clamp(ids, min=0).long()
        t_r, u_r, v_r = replay_tri(ray.o, ray.d, geom.tri_v0[gid], geom.tri_e1[gid],
                                   geom.tri_e2[gid])
        best_t = torch.where(found, t_r, best_t)
        bu = torch.where(found, u_r, 0.0)
        bv = torch.where(found, v_r, 0.0)
        kind = torch.where(found, PRIM_TRI, kind).to(torch.int32)
        prim = torch.clamp(ids, min=0)

    n_sph = geom.sph_center.shape[0]
    if n_sph >= MIN_SPHS_FOR_BVH:
        if geom.sph_bvh is None:
            raise ValueError(f"{n_sph} spheres need the spheres' LBVH (Geometry.sph_bvh); "
                             "build the scene with scene.build or scene_from_numpy")
        o, d, mint, cut = (x.detach() for x in (ray.o, ray.d, ray.mint, best_t))
        sid, t_det = isect.isect_spheres(geom.sph_bvh.detach(), o, d, mint, cut, any_hit=any_hit)
        found = sid >= 0
        gid = torch.clamp(sid, min=0).long()
        t_r = replay_sphere(ray.o, ray.d, geom.sph_center[gid], geom.sph_radius[gid], t_det)
        best_t = torch.where(found, t_r, best_t)
        kind = torch.where(found, PRIM_SPHERE, kind).to(torch.int32)
        prim = torch.where(found, sid, prim)
    elif n_sph > 0:
        tn, tf, ok = _ray_spheres(ray.o, ray.d, geom.sph_center, geom.sph_radius)
        mint = ray.mint[:, None]
        t_near_ok = ok & (tn >= mint) & (tn < best_t[:, None])
        t_far_ok = ok & (tf >= mint) & (tf < best_t[:, None])
        t_cand = torch.where(t_near_ok, tn, torch.where(t_far_ok, tf, BIG))
        j = torch.argmin(t_cand, dim=-1)
        tj = t_cand[torch.arange(n, device=dev), j]
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        kind = torch.where(better, PRIM_SPHERE, kind).to(torch.int32)
        prim = torch.where(better, j.to(torch.int32), prim)
    return Hit(t=best_t, prim_kind=kind, prim_id=prim, u=bu, v=bv)


def occluded(geom: Geometry, ray: Ray) -> torch.Tensor:
    """Shadow-ray query: True where something blocks [mint, maxt)."""
    return intersect(geom, ray, any_hit=True).prim_kind != PRIM_NONE


def make_interaction(geom: Geometry, ray: Ray, hit: Hit) -> Interaction:
    """Gather per-primitive data into a shading-ready record
    (mesh.cpp:141-186 barycentric interpolation; sphere.cpp:87-124)."""
    n = ray.o.shape[0]
    dev = ray.o.device
    is_tri = hit.prim_kind == PRIM_TRI
    is_sph = hit.prim_kind == PRIM_SPHERE
    valid = is_tri | is_sph
    # missed lanes carry t = +huge; clamp so p stays finite
    t_safe = torch.where(valid, hit.t, 1.0)
    p = ray.o + ray.d * t_safe[..., None]

    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    if geom.tri_v0.shape[0] > 0:
        tid = torch.where(is_tri, hit.prim_id, 0).long()
        w = 1.0 - hit.u - hit.v
        n_g_tri = normalize(cross(geom.tri_e1[tid], geom.tri_e2[tid]))
        n_s_tri = normalize(geom.tri_n0[tid] * w[..., None] + geom.tri_n1[tid] * hit.u[..., None]
                            + geom.tri_n2[tid] * hit.v[..., None])
        uv_tri = (geom.tri_uv0[tid] * w[..., None] + geom.tri_uv1[tid] * hit.u[..., None]
                  + geom.tri_uv2[tid] * hit.v[..., None])
        tang_tri = geom.tri_tang[tid]
        shape_tri = geom.tri_shape[tid]
    else:
        n_g_tri = n_s_tri = zeros3
        uv_tri = torch.zeros((n, 2), dtype=torch.float32, device=dev)
        tang_tri = torch.zeros((n, 4), dtype=torch.float32, device=dev)
        shape_tri = torch.zeros(n, dtype=torch.int32, device=dev)

    if geom.sph_center.shape[0] > 0:
        sid = torch.where(is_sph, hit.prim_id, 0).long()
        r = geom.sph_radius[sid]
        n_sph = normalize((p - geom.sph_center[sid]) / torch.clamp(r[..., None], min=1e-20))
        theta = torch.arccos(torch.clamp(n_sph[..., 2], -1.0, 1.0))
        phi = torch.atan2(n_sph[..., 1], n_sph[..., 0])
        phi = torch.where(phi < 0, phi + 2.0 * PI, phi)
        uv_sph = torch.stack([phi / (2.0 * PI), theta / PI], dim=-1)
        shape_sph = geom.sph_shape[sid]
    else:
        n_sph = zeros3
        uv_sph = torch.zeros((n, 2), dtype=torch.float32, device=dev)
        shape_sph = torch.zeros(n, dtype=torch.int32, device=dev)

    t3 = is_tri[..., None]
    return Interaction(
        valid=valid,
        t=hit.t,
        p=p,
        n_s=torch.where(t3, n_s_tri, n_sph),
        n_g=torch.where(t3, n_g_tri, n_sph),
        uv=torch.where(t3, uv_tri, uv_sph),
        tang=torch.where(t3, tang_tri, 0.0),
        shape=torch.where(is_tri, shape_tri, torch.where(is_sph, shape_sph, -1)).to(torch.int32),
        prim_kind=hit.prim_kind,
        prim_id=hit.prim_id,
    )
