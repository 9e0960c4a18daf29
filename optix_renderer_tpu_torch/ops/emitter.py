"""Emitters of the general path: sample / eval / pdf over the emitter table.

Counterpart of `optix_renderer_tpu/ops/emitter.py` for the emitter types the
port's builder accepts: area lights on meshes, point, spot, directional and
a constant envmap (sphere-area and volume emitters are refused by
`scene.data.check_supported`). Conventions follow the reference: `wi` points
from the shading point toward the emitter; `sample` returns eval/pdf with
the pdf in the record and the shadow interval [ε, dist − ε]; the area pdf is
solid-angle converted, (1/A)·dist²/|n·(−wi)| (arealight.cpp:104-127); delta
lights have pdf 1.
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
    squared_norm,
)
from optix_renderer_tpu_torch.ops import envmap as envmap_ops
from optix_renderer_tpu_torch.scene.data import EmitterType, SceneData


class EmitterSample(NamedTuple):
    wi: torch.Tensor  # [N,3] direction toward the emitter
    p: torch.Tensor  # [N,3] sampled point on the emitter
    n: torch.Tensor  # [N,3] emitter normal at p (0 for delta lights)
    pdf: torch.Tensor  # [N] solid-angle pdf (1 for delta)
    value: torch.Tensor  # [N,3] = eval/pdf (reference sample() return)
    shadow_maxt: torch.Tensor  # [N] occlusion-test upper bound


def _sample_mesh_surface(scene: SceneData, eid, u2):
    """Area-weighted triangle pick by the emitter's CDF (mesh.cpp:15-46,
    sampleReuse) and a uniform barycentric point → (p, n, 1/area)."""
    em = scene.emitters
    geom = scene.geometry
    cdf_rows = em.tri_cdf[eid]  # [N, MAXT]
    ux = u2[..., 0]
    local = torch.searchsorted(cdf_rows, ux[:, None].contiguous(), right=True)[:, 0]
    local = torch.minimum(torch.clamp(local, min=0), em.tri_count[eid].long() - 1)
    rows = torch.arange(eid.shape[0], device=eid.device)
    lo = torch.where(local > 0, cdf_rows[rows, torch.clamp(local - 1, min=0)], 0.0)
    hi = cdf_rows[rows, local]
    ux_re = torch.clamp((ux - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0 - 1e-7)
    n_tris = geom.tri_v0.shape[0]
    tri = torch.clamp(em.tri_offset[eid].long() + local, 0, max(n_tris - 1, 0))
    bc = warp.square_to_uniform_triangle(torch.stack([ux_re, u2[..., 1]], dim=-1))
    if n_tris > 0:
        p = geom.tri_v0[tri] + geom.tri_e1[tri] * bc[..., 1:2] + geom.tri_e2[tri] * bc[..., 2:3]
        nrm = normalize(geom.tri_n0[tri] * bc[..., 0:1] + geom.tri_n1[tri] * bc[..., 1:2]
                        + geom.tri_n2[tri] * bc[..., 2:3])
    else:
        p = nrm = torch.zeros(u2.shape[0], 3, device=u2.device)
    inv_area = 1.0 / torch.clamp(em.area[eid], min=1e-20)
    return p, nrm, inv_area


def _spot_falloff(scene: SceneData, eid, w):
    """Spotlight angular falloff (spotlight.cpp:184-203): delta⁴ ramp."""
    em = scene.emitters
    cos_theta = dot(w, em.direction[eid])
    c_start = em.cos_falloff_start[eid]
    c_end = em.cos_falloff_end[eid]
    delta = (cos_theta - c_end) / torch.clamp(c_start - c_end, min=1e-12)
    ramp = torch.clamp(delta, 0.0, 1.0) ** 4
    return torch.where(cos_theta < c_end, 0.0, torch.where(cos_theta >= c_start, 1.0, ramp))


def sample_emitter(scene: SceneData, em_id, ref, u3) -> EmitterSample:
    """Sample every emitter type branch-free and select by `em_id`'s type.
    `u3` is [N,3]; surface and direction emitters use its first two."""
    em = scene.emitters
    eid = torch.clamp(em_id, min=0).long()
    etype = em.type[eid]
    u2 = u3[..., :2]
    radiance = em.radiance[eid]

    # area (arealight.cpp:75-101)
    p_surf, n_surf, inv_area = _sample_mesh_surface(scene, eid, u2)
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

    # constant envmap (environmentmap.cpp:84-88): uniform sphere
    wi_env, pdf_env, rad_env = envmap_ops.sample_dir(scene.envmap_radiance, u2)
    val_env = rad_env / torch.clamp(pdf_env, min=1e-20)[..., None]

    is_area = etype == EmitterType.AREA
    is_point = etype == EmitterType.POINT
    is_spot = etype == EmitterType.SPOT
    is_dir = etype == EmitterType.DIRECTIONAL
    is_delta = is_point | is_spot
    a_, d_, r_ = is_area[..., None], is_delta[..., None], is_dir[..., None]

    wi = torch.where(a_, wi_area, torch.where(d_, wi_pt, torch.where(r_, wi_dir, wi_env)))
    p = torch.where(a_, p_surf, torch.where(d_, em.position[eid], ref + wi * 1e8))
    nrm = torch.where(a_, n_surf, 0.0)
    pdf = torch.where(is_area, pdf_area,
                      torch.where(is_delta, 1.0, torch.where(is_dir, pdf_dir, pdf_env)))
    value = torch.where(a_, val_area, torch.where(
        is_point[..., None], val_point,
        torch.where(is_spot[..., None], val_spot, torch.where(r_, val_dir, val_env))))
    shadow_maxt = torch.where(is_area | is_delta,
                              torch.where(is_area, dist_area, dist_pt) - EPSILON, float("inf"))
    return EmitterSample(wi=wi, p=p, n=nrm, pdf=pdf, value=value, shadow_maxt=shadow_maxt)


def eval_hit_emitter(scene: SceneData, em_id, wi, n) -> torch.Tensor:
    """Radiance of an emitter hit by a ray (area front-face check,
    arealight.cpp:58-72); `wi` = direction from the viewer toward it."""
    em = scene.emitters
    eid = torch.clamp(em_id, min=0).long()
    front = dot(n, -wi) >= 0.0
    val = torch.where(((em.type[eid] == EmitterType.AREA) & front)[..., None],
                      em.radiance[eid], 0.0)
    return torch.where(em_id[..., None] >= 0, val, 0.0)


def pdf_hit_emitter(scene: SceneData, em_id, ref, p, n, wi) -> torch.Tensor:
    """Solid-angle pdf with which `sample_emitter` would have produced this
    hit — the MATS-side MIS probe (path_mis.cpp:123-125)."""
    em = scene.emitters
    eid = torch.clamp(em_id, min=0).long()
    cos_e = dot(n, -wi)
    inv_area = 1.0 / torch.clamp(em.area[eid], min=1e-20)
    dist2 = squared_norm(p - ref)
    pdf_area = torch.where(cos_e > 0.0,
                           inv_area * dist2 / torch.clamp(torch.abs(cos_e), min=1e-12), 0.0)
    return torch.where((em.type[eid] == EmitterType.AREA) & (em_id >= 0), pdf_area, 0.0)


def pdf_envmap_direction(scene: SceneData, d) -> torch.Tensor:
    """Solid-angle pdf with which `sample_emitter` draws direction `d` from
    the envmap emitter (0 without one); used to MIS-weight the miss term."""
    if scene.envmap_emitter < 0:
        return torch.zeros(d.shape[:-1], dtype=torch.float32, device=d.device)
    return envmap_ops.pdf_dir(d)


def eval_envmap(scene: SceneData, d) -> torch.Tensor:
    """Environment radiance for escaped rays; 0 without an envmap emitter."""
    if scene.envmap_emitter < 0:
        return torch.zeros_like(d)
    return envmap_ops.eval_dir(scene.envmap_radiance, normalize(d))
