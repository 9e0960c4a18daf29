"""Shared integrator machinery: shading context, next-event estimation, AOVs.

Counterpart of `optix_renderer_tpu/integrators/common.py`: the per-hit setup
every reference integrator repeats (shape → BSDF / emitter, shading frame,
`its.toLocal / toWorld`) as batched helpers over a ray wavefront.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from optix_renderer_tpu_torch.core import dpdf
from optix_renderer_tpu_torch.core.math import (
    EPSILON,
    Frame,
    Ray,
    cross,
    dot,
    frame_to_local,
    frame_to_world,
    make_frame,
    normalize,
)
from optix_renderer_tpu_torch.ops import bsdf as bsdf_ops
from optix_renderer_tpu_torch.ops import emitter as emitter_ops
from optix_renderer_tpu_torch.ops.intersect import (
    Interaction,
    intersect,
    make_interaction,
    occluded,
)
from optix_renderer_tpu_torch.ops.texture import eval_texture
from optix_renderer_tpu_torch.scene.data import SceneData


class ShadingCtx(NamedTuple):
    """Per-lane hit context (the reference `Intersection` + plugin lookups)."""

    its: Interaction
    frame: Frame  # shading frame (normal-mapped where a normal map is attached)
    bsdf_id: torch.Tensor  # [N]
    emitter_id: torch.Tensor  # [N] (−1 none)


def trace(scene: SceneData, ray: Ray) -> ShadingCtx:
    """Closest hit + shading setup; missed lanes get BSDF 0 / emitter −1.

    Tangent-space normal mapping (mesh.cpp:141-186, common.py:48-71 of the
    JAX package): where the shape has a normal map, n_s is perturbed by the
    texture's normal in a UV-aligned TBN frame whose bitangent carries the
    UV chart's handedness (`tang.w`), so mirrored charts keep the map's
    green channel; triangles with a degenerate UV chart, and spheres, fall
    back to the Duff frame of n_s. A scene without normal maps skips the
    map's arithmetic (`Shapes.mapped`), which would select n_s everywhere.
    """
    hit = intersect(scene.geometry, ray)
    its = make_interaction(scene.geometry, ray, hit)
    sid = torch.clamp(its.shape, min=0).long()
    bsdf_id = torch.where(its.valid, scene.shapes.bsdf[sid], 0)
    emitter_id = torch.where(its.valid, scene.shapes.emitter[sid], -1)

    n = its.n_s
    if not scene.shapes.mapped:
        return ShadingCtx(its=its, frame=make_frame(normalize(n)), bsdf_id=bsdf_id,
                          emitter_id=emitter_id)
    ntex = scene.shapes.normal_tex[sid]
    fallback = make_frame(n)
    tang3 = its.tang[..., :3]
    t_proj = tang3 - n * dot(n, tang3)[..., None]
    has_tbn = ((t_proj * t_proj).sum(dim=-1) > 1e-12)[..., None]
    t_hat = normalize(torch.where(has_tbn, t_proj, fallback.s))
    b_hat = its.tang[..., 3:4] * cross(n, t_hat)
    tbn = Frame(s=torch.where(has_tbn, t_hat, fallback.s),
                t=torch.where(has_tbn, b_hat, fallback.t), n=n)
    tex_n = eval_texture(scene.textures, ntex, its.uv) * 2.0 - 1.0
    pert = normalize(frame_to_world(tbn, tex_n))
    n2 = torch.where(((ntex >= 0) & its.valid)[..., None], pert, n)
    frame = make_frame(normalize(n2))
    return ShadingCtx(its=its, frame=frame, bsdf_id=bsdf_id, emitter_id=emitter_id)


def to_local(ctx: ShadingCtx, v: torch.Tensor) -> torch.Tensor:
    return frame_to_local(ctx.frame, v)


def to_world(ctx: ShadingCtx, v: torch.Tensor) -> torch.Tensor:
    return frame_to_world(ctx.frame, v)


def hit_emitter_radiance(scene: SceneData, ctx: ShadingCtx, ray_d: torch.Tensor):
    """`shape->getEmitter()->eval(...)` when a path hits an emissive surface."""
    return emitter_ops.eval_hit_emitter(scene, ctx.emitter_id, normalize(ray_d), ctx.frame.n)


def pick_emitter(scene: SceneData, u1: torch.Tensor) -> torch.Tensor:
    """scene->getRandomEmitter via the lightProb distribution."""
    return dpdf.sample(scene.emitter_pick, u1)


def nee(scene: SceneData, ctx: ShadingCtx, wo_local, em_id, u3, n_lights: int,
        abs_cos: bool = False):
    """One next-event-estimation try against emitter `em_id` (u3: [N,3]).

    Returns (contrib [N,3] already scaled ×n_lights as the reference does,
    pdf_ems [N] divided by n_lights, pdf_mat [N] BSDF pdf toward the light,
    visible [N]) — path_mis.cpp:74-106.
    """
    es = emitter_ops.sample_emitter(scene, em_id, ctx.its.p, u3)
    wi_local = to_local(ctx, es.wi)
    nonzero = torch.any(torch.abs(es.value) > EPSILON, dim=-1)
    shadow_ray = Ray(o=ctx.its.p, d=es.wi, mint=torch.full_like(es.pdf, EPSILON),
                     maxt=es.shadow_maxt)
    visible = nonzero & ~occluded(scene.geometry, shadow_ray) & ctx.its.valid
    f = bsdf_ops.eval_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local, wi_local,
                           ctx.its.uv)
    cos = dot(es.wi, ctx.frame.n)
    if abs_cos:
        cos = torch.abs(cos)
    contrib = es.value * cos[..., None] * f * float(n_lights)
    contrib = torch.where(visible[..., None], contrib, 0.0)
    pdf_mat = bsdf_ops.pdf_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local, wi_local,
                                ctx.its.uv)
    pdf_mat = torch.where(visible, pdf_mat, 0.0)
    pdf_ems = torch.where(visible, es.pdf / float(n_lights), 0.0)
    return contrib, pdf_ems, pdf_mat, visible


def first_hit_aovs(scene: SceneData, ctx: ShadingCtx):
    """Albedo + shading-normal feature buffers (integrator.h:29-39)."""
    albedo = eval_texture(scene.textures,
                          scene.bsdfs.albedo_tex[torch.clamp(ctx.bsdf_id, min=0).long()],
                          ctx.its.uv)
    valid = ctx.its.valid[..., None]
    return torch.where(valid, albedo, 0.0), torch.where(valid, ctx.frame.n, 0.0)


def miss_envmap(scene: SceneData, ray_d: torch.Tensor, active: torch.Tensor):
    """Environment contribution for escaped rays."""
    return torch.where(active[..., None], emitter_ops.eval_envmap(scene, ray_d), 0.0)
