"""Emitters of the general path: sample / eval / pdf over the emitter table.

Counterpart of `optix_renderer_tpu/ops/emitter.py`: area lights on meshes
and spheres, point, spot, directional, volume emitters and an envmap,
constant or image-based (`ops/envmap.py`). Conventions follow the
reference: `wi` points from the shading point toward the emitter; `sample`
returns eval/pdf with the pdf in the record and the shadow interval
[ε, dist − ε]; the area pdf is solid-angle converted,
(1/A)·dist²/|n·(−wi)| (arealight.cpp:104-127), a volume emitter's
dist²/volume (volumelight.cpp:73-77); delta lights have pdf 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from optix_renderer_tpu_torch.core import warp
from optix_renderer_tpu_torch.core.math import (
    EPSILON,
    PI,
    dot,
    frame_to_world,
    make_frame,
    normalize,
    rows,
    squared_norm,
)
from optix_renderer_tpu_torch.ops import envmap as envmap_ops
from optix_renderer_tpu_torch.scene.data import EmitterGeom, EmitterType, SceneData


class EmitterSample(NamedTuple):
    wi: torch.Tensor  # [N,3] direction toward the emitter
    p: torch.Tensor  # [N,3] sampled point on the emitter
    n: torch.Tensor  # [N,3] emitter normal at p (0 for delta lights)
    pdf: torch.Tensor  # [N] solid-angle pdf (1 for delta)
    value: torch.Tensor  # [N,3] = eval/pdf (reference sample() return)
    shadow_maxt: torch.Tensor  # [N] occlusion-test upper bound


def _sample_shape_surface(scene: SceneData, eid, u2):
    """A point on the emitter's shape → (p, n, 1/area). Mesh: an area-weighted
    triangle pick by the emitter's CDF (mesh.cpp:15-46, sampleReuse) and a
    uniform barycentric point; sphere: uniform over its surface
    (sphere.cpp:126-137). Without a sphere light (`Emitters.sphere_lights`)
    the sphere branch is skipped: only an area emitter on neither a mesh nor
    a sphere would read it, and the builders make none."""
    em = scene.emitters
    geom = scene.geometry
    n_lanes = eid.shape[0]
    cdf_rows = em.tri_cdf[eid]  # [N, MAXT]
    ux = u2[..., 0]
    local = torch.searchsorted(cdf_rows, ux[:, None].contiguous(), right=True)[:, 0]
    local = torch.minimum(torch.clamp(local, min=0), em.tri_count[eid].long() - 1)
    rows = torch.arange(n_lanes, device=eid.device)
    lo = torch.where(local > 0, cdf_rows[rows, torch.clamp(local - 1, min=0)], 0.0)
    hi = cdf_rows[rows, local]
    ux_re = torch.clamp((ux - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0 - 1e-7)
    n_tris = geom.tri_v0.shape[0]
    tri = torch.clamp(em.tri_offset[eid].long() + local, 0, max(n_tris - 1, 0))
    bc = warp.square_to_uniform_triangle(torch.stack([ux_re, u2[..., 1]], dim=-1))
    zeros = torch.zeros(n_lanes, 3, device=u2.device)
    if n_tris > 0:
        p_mesh = (geom.tri_v0[tri] + geom.tri_e1[tri] * bc[..., 1:2]
                  + geom.tri_e2[tri] * bc[..., 2:3])
        n_mesh = normalize(geom.tri_n0[tri] * bc[..., 0:1] + geom.tri_n1[tri] * bc[..., 1:2]
                           + geom.tri_n2[tri] * bc[..., 2:3])
    else:
        p_mesh = n_mesh = zeros
    inv_area = 1.0 / torch.clamp(em.area[eid], min=1e-20)
    if not em.sphere_lights:
        return p_mesh, n_mesh, inv_area
    if geom.sph_center.shape[0] > 0:
        sid = torch.clamp(em.sphere_id[eid], min=0).long()
        n_sph = warp.square_to_uniform_sphere(u2)
        p_sph = geom.sph_center[sid] + geom.sph_radius[sid][..., None] * n_sph
    else:
        p_sph = n_sph = zeros
    is_mesh = (em.geom_kind[eid] == EmitterGeom.MESH)[..., None]
    return torch.where(is_mesh, p_mesh, p_sph), torch.where(is_mesh, n_mesh, n_sph), inv_area


def _spot_falloff(scene: SceneData, eid, w):
    """Spotlight angular falloff (spotlight.cpp:184-203): delta⁴ ramp."""
    em = scene.emitters
    cos_theta = dot(w, em.direction[eid])
    c_start = em.cos_falloff_start[eid]
    c_end = em.cos_falloff_end[eid]
    delta = (cos_theta - c_end) / torch.clamp(c_start - c_end, min=1e-12)
    ramp = torch.clamp(delta, 0.0, 1.0) ** 4
    return torch.where(cos_theta < c_end, 0.0, torch.where(cos_theta >= c_start, 1.0, ramp))


def _sample_volume(scene: SceneData, eid, ref, u3):
    """A point of a volume emitter's shape (volumelight.cpp:52-77): uniform
    in a sphere's ball (sphere.cpp:139-143), else in the mesh's bbox
    (shape.cpp:97-101), from all three components of u3 → (wi, p, pdf,
    value, dist)."""
    em, geom = scene.emitters, scene.geometry
    p = em.bbox_min[eid] + em.bbox_extent[eid] * u3
    if geom.sph_center.shape[0] > 0:
        sid = torch.clamp(em.sphere_id[eid], min=0).long()
        ball = geom.sph_center[sid] + geom.sph_radius[sid][..., None] * \
            warp.square_to_uniform_sphere_volume(u3)
        p = torch.where((em.geom_kind[eid] == EmitterGeom.SPHERE)[..., None], ball, p)
    to_v = p - ref
    dist2 = torch.clamp(squared_norm(to_v), min=1e-20)
    dist = torch.sqrt(dist2)
    pdf = dist2 / torch.clamp(em.volume[eid], min=1e-20)
    return (to_v / dist[..., None], p, pdf,
            rows(em.radiance, eid) / torch.clamp(pdf, min=1e-12)[..., None], dist)


def sample_emitter(scene: SceneData, em_id, ref, u3) -> EmitterSample:
    """Sample every emitter type branch-free and select by `em_id`'s type.
    `u3` is [N,3]; surface and direction emitters use its first two, volume
    emitters all three. Without a volume emitter (`Emitters.volume_lights`)
    the volume branch is skipped."""
    em = scene.emitters
    eid = torch.clamp(em_id, min=0).long()
    etype = em.type[eid]
    u2 = u3[..., :2]
    radiance = rows(em.radiance, eid)

    # area (arealight.cpp:75-101)
    p_surf, n_surf, inv_area = _sample_shape_surface(scene, eid, u2)
    to_p = p_surf - ref
    dist2_area = squared_norm(to_p)
    dist_area = torch.sqrt(torch.clamp(dist2_area, min=1e-20))
    wi_area = to_p / dist_area[..., None]
    cos_emitter = dot(n_surf, -wi_area)
    front = cos_emitter > 0.0
    pdf_area = inv_area * dist2_area / torch.clamp(torch.abs(cos_emitter), min=1e-12)
    val_area = torch.where((front & (pdf_area > EPSILON))[..., None],
                           radiance / torch.clamp(pdf_area, min=1e-12)[..., None], 0.0)

    # point (pointlight.cpp): eval = power/(4π·dist²), pdf = 1
    to_l = em.position[eid] - ref
    dist2_pt = torch.clamp(squared_norm(to_l), min=1e-20)
    dist_pt = torch.sqrt(dist2_pt)
    wi_pt = to_l / dist_pt[..., None]
    val_point = radiance / dist2_pt[..., None]

    # spot (spotlight.cpp:54-74): radiance = power/2π over the normalized cone
    i_spot = (em.power[eid] / (2.0 * PI)) / torch.clamp(
        1.0 - 0.5 * (em.cos_falloff_end[eid] + em.cos_falloff_start[eid]), min=1e-12)[..., None]
    val_spot = i_spot * _spot_falloff(scene, eid, -wi_pt)[..., None] / dist2_pt[..., None]

    # directional (directionalLight.cpp:90-136): cap around −direction
    cos_cap = torch.cos(em.angular_radius[eid])
    cap_local = warp.square_to_uniform_sphere_cap(u2, cos_cap)
    wi_dir = -frame_to_world(make_frame(em.direction[eid]), cap_local)
    pdf_dir = 1.0 / torch.clamp(2.0 * PI * (1.0 - cos_cap), min=1e-12)
    val_dir = radiance / pdf_dir[..., None]

    # envmap (environmentmap.cpp:73-104): luminance-importance sampled, a
    # constant (1×1) map uniformly over the sphere
    wi_env, pdf_env, rad_env = envmap_ops.sample_dir(scene.envmap, scene.envmap_pick, u2)
    val_env = rad_env / torch.clamp(pdf_env, min=1e-20)[..., None]

    is_area = etype == EmitterType.AREA
    is_point = etype == EmitterType.POINT
    is_spot = etype == EmitterType.SPOT
    is_dir = etype == EmitterType.DIRECTIONAL
    is_delta = is_point | is_spot
    a_, d_, r_ = is_area[..., None], is_delta[..., None], is_dir[..., None]

    # the volume branch selects before the envmap, as in the JAX package
    if em.volume_lights:
        wi_vol, p_vol, pdf_vol, val_vol, dist_vol = _sample_volume(scene, eid, ref, u3)
        is_vol = etype == EmitterType.VOLUME
        v_ = is_vol[..., None]
        wi_env = torch.where(v_, wi_vol, wi_env)
        pdf_env = torch.where(is_vol, pdf_vol, pdf_env)
        val_env = torch.where(v_, val_vol, val_env)
    wi = torch.where(a_, wi_area, torch.where(d_, wi_pt, torch.where(r_, wi_dir, wi_env)))
    p_far = ref + wi * 1e8
    nrm = torch.where(a_, n_surf, 0.0)
    dist = torch.where(is_area, dist_area, dist_pt)
    finite = is_area | is_delta
    if em.volume_lights:
        p_far = torch.where(v_, p_vol, p_far)
        nrm = torch.where(v_, -wi_vol, nrm)  # volumelight.cpp:64
        dist = torch.where(is_vol, dist_vol, dist)
        finite = finite | is_vol
    p = torch.where(a_, p_surf, torch.where(d_, em.position[eid], p_far))
    pdf = torch.where(is_area, pdf_area,
                      torch.where(is_delta, 1.0, torch.where(is_dir, pdf_dir, pdf_env)))
    value = torch.where(a_, val_area, torch.where(
        is_point[..., None], val_point,
        torch.where(is_spot[..., None], val_spot, torch.where(r_, val_dir, val_env))))
    shadow_maxt = torch.where(finite, dist - EPSILON, float("inf"))
    return EmitterSample(wi=wi, p=p, n=nrm, pdf=pdf, value=value, shadow_maxt=shadow_maxt)


def eval_hit_emitter(scene: SceneData, em_id, wi, n) -> torch.Tensor:
    """Radiance of an emitter hit by a ray (area front-face check,
    arealight.cpp:58-72); `wi` = direction from the viewer toward it."""
    em = scene.emitters
    eid = torch.clamp(em_id, min=0).long()
    front = dot(n, -wi) >= 0.0
    val = torch.where(((em.type[eid] == EmitterType.AREA) & front)[..., None],
                      rows(em.radiance, eid), 0.0)
    return torch.where(em_id[..., None] >= 0, val, 0.0)


def pdf_hit_emitter(scene: SceneData, em_id, ref, p, n, wi) -> torch.Tensor:
    """Solid-angle pdf with which `sample_emitter` would have produced this
    hit — the MATS-side MIS probe (path_mis.cpp:123-125); one formula for
    mesh and sphere area lights, (1/A)·dist²/cos."""
    em = scene.emitters
    eid = torch.clamp(em_id, min=0).long()
    cos_e = dot(n, -wi)
    inv_area = 1.0 / torch.clamp(em.area[eid], min=1e-20)
    dist2 = squared_norm(p - ref)
    pdf_area = torch.where(cos_e > 0.0,
                           inv_area * dist2 / torch.clamp(torch.abs(cos_e), min=1e-12), 0.0)
    return torch.where((em.type[eid] == EmitterType.AREA) & (em_id >= 0), pdf_area, 0.0)


def pdf_volume_emitter(scene: SceneData, em_id, ref, p) -> torch.Tensor:
    """Solid-angle pdf with which `sample_emitter` produces volume point `p`
    from `ref` (volumelight.cpp:73-77: dist²/volume); 0 for other types."""
    em = scene.emitters
    eid = torch.clamp(em_id, min=0).long()
    pdf = squared_norm(p - ref) / torch.clamp(em.volume[eid], min=1e-20)
    return torch.where((em.type[eid] == EmitterType.VOLUME) & (em_id >= 0), pdf, 0.0)


def pdf_envmap_direction(scene: SceneData, d) -> torch.Tensor:
    """Solid-angle pdf with which `sample_emitter` draws direction `d` from
    the envmap emitter (0 without one); used to MIS-weight the miss term."""
    if scene.envmap_emitter < 0:
        return torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
    return envmap_ops.pdf_dir(scene.envmap, scene.envmap_pick, d)


def eval_envmap(scene: SceneData, d) -> torch.Tensor:
    """Environment radiance for escaped rays; 0 without an envmap emitter."""
    if scene.envmap_emitter < 0:
        return torch.zeros_like(d)
    return envmap_ops.eval_dir(scene.envmap, normalize(d))
