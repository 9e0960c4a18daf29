"""Volumetric wavefront path tracers: path_vol_mats and path_vol_mis.

Counterpart of `optix_renderer_tpu/integrators/volpath.py` (reference
path_vol_mats.cpp / path_vol_mis.cpp), bounce for bounce: free-path
sampling against the surface hit (`ops/medium.py: sample_interaction`),
phase-function scattering, pass-through medium boundaries (shapes without
a BSDF), medium transitions on transmission, and, with MIS, shadow rays
that accumulate transmittance through boundaries with balance-heuristic
emitter weights. Volume lights are sampled by NEE from every real
scattering vertex and counted on the MATS side only after a delta prefix
(the JAX package's strategy split). Russian roulette from bounce 3, at
real interactions only (path_vol_mis.cpp:176-185). The JAX `lax.scan` is a
Python loop; the sampler is drawn in the JAX order, so the streams match.
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core.math import (
    EPSILON,
    Ray,
    dot,
    frame_to_local,
    frame_to_world,
    make_frame,
    normalize,
    rows,
)
from optix_renderer_tpu_torch.integrators import common
from optix_renderer_tpu_torch.ops import bsdf as bsdf_ops
from optix_renderer_tpu_torch.ops import emitter as emitter_ops
from optix_renderer_tpu_torch.ops import medium as medium_ops
from optix_renderer_tpu_torch.ops.intersect import intersect, make_interaction
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.scene.data import EmitterType, RenderConfig, SceneData


def _next_medium(scene: SceneData, sid, d, n_g, med):
    """The medium past a boundary crossed in direction d: the shape's
    interior when entering it (d·n_g < 0 and it has one), else the ambient
    medium (path_vol_mis.cpp:70-77, 230-236)."""
    interior = scene.shapes.interior_medium[sid]
    entering = (dot(d, n_g) < 0.0) & (interior >= 0)
    return torch.where(entering, interior, torch.full_like(med, scene.ambient_medium))


def _shadow_transmittance(scene: SceneData, s, p_from, wi, maxt, medium_id, n_segments: int):
    """Transmittance of a shadow ray through pass-through boundaries, 0 where
    a hit carries a BSDF (traceShadowray, path_vol_mis.cpp:26-46, bounded
    by `n_segments` closest-hit traces) → (sampler, Tr [N,3])."""
    n = p_from.shape[0]
    tr = torch.ones((n, 3), device=p_from.device)
    blocked = torch.zeros(n, dtype=torch.bool, device=p_from.device)
    o, remaining, med = p_from, maxt, medium_id
    for _ in range(n_segments):
        ray = Ray(o=o, d=wi, mint=torch.full_like(remaining, EPSILON), maxt=remaining)
        its = make_interaction(scene.geometry, ray, intersect(scene.geometry, ray))
        sid = torch.clamp(its.shape, min=0).long()
        has_bsdf = its.valid & (scene.shapes.bsdf[sid] >= 0)
        blocked = blocked | has_bsdf
        seg = torch.where(its.valid, its.t, remaining)
        s, tr_seg = medium_ops.transmittance_est(scene.media, med, s, o, wi, seg)
        tr = tr * tr_seg
        med = torch.where(its.valid & ~has_bsdf, _next_medium(scene, sid, wi, its.n_g, med), med)
        o = torch.where(its.valid[..., None], its.p, o)
        remaining = torch.where(its.valid, remaining - its.t, 0.0)
    return s, torch.where(blocked[..., None], 0.0, tr)


def li_vol(scene: SceneData, config: RenderConfig, ray: Ray, sampler, use_mis: bool):
    n = ray.o.shape[0]
    dev = ray.o.device
    n_lights = max(config.n_emitters, 1)
    media = scene.media
    ro, rd = ray.o, ray.d
    t = torch.ones((n, 3), device=dev)
    L = torch.zeros((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    med = torch.full((n,), scene.ambient_medium, dtype=torch.int32, device=dev)
    pdf_mat = torch.ones(n, device=dev)  # the camera is like a delta BSDF
    pdf_discrete = torch.ones(n, dtype=torch.bool, device=dev)
    # pv: the last real scattering vertex (camera, BSDF or phase event); a
    # pass-through boundary moves ro but not pv, so MATS-side emitter pdfs
    # stay in the solid-angle measure of the vertex that sampled pdf_mat
    pv = ray.o
    albedo = torch.zeros((n, 3), device=dev)
    normal = torch.zeros((n, 3), device=dev)
    s = sampler
    for bounce in range(config.max_depth):
        # the first segment keeps the camera's near / far clip
        if bounce == 0:
            r = Ray(o=ro, d=rd, mint=ray.mint, maxt=ray.maxt)
        else:
            r = Ray(o=ro, d=rd, mint=torch.full_like(ray.mint, EPSILON),
                    maxt=torch.full_like(ray.maxt, float("inf")))
        ctx = common.trace(scene, r)

        # miss → envmap (MIS-weighted as in path_mis), terminate. pdf_discrete
        # holds at the first vertex, so a weight there is 1
        env = common.miss_envmap(scene, rd, active & ~ctx.its.valid)
        if use_mis:
            pdf_env_dir = emitter_ops.pdf_envmap_direction(scene, rd) / float(n_lights)
            denom_env = pdf_mat + pdf_env_dir
            w_env = torch.where(denom_env > EPSILON,
                                pdf_mat / torch.clamp(denom_env, min=1e-20), 1.0)
            L = L + torch.where(pdf_discrete, 1.0, w_env)[..., None] * t * env
        else:
            L = L + t * env
        active = active & ctx.its.valid
        if bounce == 0:
            albedo, normal = common.first_hit_aovs(scene, ctx)

        # free-path sampling in the current medium
        s, is_medium, t_med, w_medium, w_surface, w_emission = medium_ops.sample_interaction(
            media, med, s, ro, rd, ctx.its.t)
        is_medium = is_medium & active
        p = torch.where(is_medium[..., None], ro + rd * t_med[..., None], ctx.its.p)

        # medium emission at real medium events, with the throughput before
        # this event: a volume emitter's radiance (MATS side only after a
        # delta prefix under MIS; NEE covers the rest) and temperature
        # emission (no NEE: weight 1)
        med_em = torch.where(med >= 0, media.emitter[torch.clamp(med, min=0).long()], -1)
        has_med_em = is_medium & (med_em >= 0)
        le_const = torch.where(has_med_em[..., None],
                               rows(scene.emitters.radiance, torch.clamp(med_em, min=0).long()),
                               0.0)
        if use_mis:
            le_const = torch.where(pdf_discrete[..., None], le_const, 0.0)
        le_temp = medium_ops.event_emission(media, med, p)
        L = L + torch.where(is_medium[..., None], t * w_emission * (le_const + le_temp), 0.0)
        t = torch.where(active[..., None],
                        t * torch.where(is_medium[..., None], w_medium, w_surface), t)

        sid = torch.clamp(ctx.its.shape, min=0).long()
        has_bsdf = ctx.its.valid & (scene.shapes.bsdf[sid] >= 0) & ~is_medium

        # MATS-side hit of a surface emitter
        hit_em = active & ~is_medium & (ctx.emitter_id >= 0)
        if use_mis:
            pdf_ems_here = emitter_ops.pdf_hit_emitter(
                scene, ctx.emitter_id, pv, ctx.its.p, ctx.frame.n, normalize(rd)) / float(n_lights)
            denom = pdf_mat + pdf_ems_here
            w_mats = torch.where(denom > EPSILON, pdf_mat / torch.clamp(denom, min=1e-20), 0.0)
            w_mats = torch.where(pdf_discrete, 1.0, w_mats)
        else:
            w_mats = torch.ones(n, device=dev)
        L = L + torch.where(hit_em[..., None],
                            w_mats[..., None] * t * common.hit_emitter_radiance(scene, ctx, rd),
                            0.0)

        # Russian roulette from bounce 3, at real interactions only
        s, u_rr = smp.next_1d(s)
        if bounce >= 3:
            succ = torch.clamp(t.amax(dim=-1), max=0.99)
            rr_on = (is_medium | has_bsdf) & active
            die = rr_on & ((u_rr > succ) | (succ < EPSILON))
            t = torch.where(rr_on[..., None], t / torch.clamp(succ, min=1e-12)[..., None], t)
            active = active & ~die

        # next direction: a phase sample in the frame of rd at a medium
        # event, a BSDF sample at a surface
        s, u_ph = smp.next_2d(s)
        ray_frame = make_frame(normalize(rd))
        wo_phase_local = medium_ops.phase_sample(media, med, u_ph)
        wo_phase = frame_to_world(ray_frame, wo_phase_local)
        pdf_phase = medium_ops.phase_pdf(media, med, wo_phase_local)
        wo_local_view = common.to_local(ctx, -normalize(rd))
        s, u_bs = smp.next_2d(s)
        bs = bsdf_ops.sample_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local_view,
                                  ctx.its.uv, u_bs)
        wo_surf = common.to_world(ctx, bs.wo)
        wo = torch.where(is_medium[..., None], wo_phase,
                         torch.where(has_bsdf[..., None], wo_surf, rd))
        new_pdf_mat = torch.where(is_medium, pdf_phase, torch.where(has_bsdf, bs.pdf, pdf_mat))
        new_discrete = ~is_medium & torch.where(has_bsdf, bs.is_discrete, pdf_discrete)

        # NEE through media (MIS only; path_vol_mis.cpp:48-105)
        if use_mis:
            s, u_pick = smp.next_1d(s)
            em_id = common.pick_emitter(scene, u_pick)
            s, u_ems = smp.next_3d(s)
            es = emitter_ops.sample_emitter(scene, em_id, p, u_ems)
            # the shadow ray's medium: the current one at a medium event or
            # a reflection, the one past the boundary on transmission
            crossed = _next_medium(scene, sid, es.wi, ctx.its.n_g, med)
            shadow_med = torch.where(~is_medium & (dot(rd, es.wi) > 0.0), crossed, med)
            s, tr = _shadow_transmittance(scene, s, p, es.wi, es.shadow_maxt, shadow_med,
                                          config.shadow_segments)
            wi_local_surface = common.to_local(ctx, es.wi)
            f_surf = bsdf_ops.eval_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local_view,
                                        wi_local_surface, ctx.its.uv)
            cos_surf = dot(es.wi, ctx.frame.n)
            pdf_mat_surf = bsdf_ops.pdf_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id,
                                             wo_local_view, wi_local_surface, ctx.its.uv)
            # the phase function's value equals its pdf
            pdf_mat_phase = medium_ops.phase_pdf(media, med, frame_to_local(ray_frame, es.wi))
            f_ems = torch.where(is_medium[..., None], pdf_mat_phase[..., None].expand(-1, 3),
                                f_surf * torch.clamp(cos_surf, min=0.0)[..., None])
            pdf_mat_ems = torch.where(is_medium, pdf_mat_phase, pdf_mat_surf)
            pdf_ems = es.pdf / float(n_lights)
            w_ems = torch.where(pdf_ems > EPSILON,
                                pdf_ems / torch.clamp(pdf_ems + pdf_mat_ems, min=1e-20), 0.0)
            # volume lights are NEE-only
            is_vol_light = scene.emitters.type[torch.clamp(em_id, min=0).long()] == \
                EmitterType.VOLUME
            w_ems = torch.where(is_vol_light & (pdf_ems > EPSILON), 1.0, w_ems)
            valid_ems = active & (is_medium | (has_bsdf & ~bs.is_discrete))
            contrib = w_ems[..., None] * t * tr * es.value * float(n_lights) * f_ems
            L = L + torch.where(valid_ems[..., None], contrib, 0.0)

        # the surface throughput after NEE (path_vol_mis.cpp:225-228)
        t = torch.where(has_bsdf[..., None], t * bs.weight, t)
        # medium transition on transmission (path_vol_mis.cpp:230-236)
        crossing = ~is_medium & ctx.its.valid & (dot(rd, wo) > 0.0) & active
        med = torch.where(crossing, _next_medium(scene, sid, wo, ctx.its.n_g, med), med)

        active = active & ~(torch.abs(t) < 1e-12).all(dim=-1)
        pv = torch.where((active & (is_medium | has_bsdf))[..., None], p, pv)
        ro = torch.where(active[..., None], p, ro)
        rd = torch.where(active[..., None], wo, rd)
        pdf_mat, pdf_discrete = new_pdf_mat, new_discrete
    return L, albedo, normal, s


def li_path_vol_mats(scene, config, ray, sampler):
    """Registry entry for `path_vol_mats` (src/integrators/path_vol_mats.cpp)."""
    return li_vol(scene, config, ray, sampler, use_mis=False)


def li_path_vol_mis(scene, config, ray, sampler):
    """Registry entry for `path_vol_mis` (src/integrators/path_vol_mis.cpp)."""
    return li_vol(scene, config, ray, sampler, use_mis=True)
