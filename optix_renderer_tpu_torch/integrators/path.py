"""Wavefront path tracers: path_mats and path_mis.

Counterpart of `optix_renderer_tpu/integrators/path.py`. The JAX package's
`lax.scan` over bounces is a Python loop here: the whole wavefront advances
one bounce per step and dead lanes are masked. MIS weights are computed
lazily: the MATS-side pdf is carried to the next hit instead of tracing a
second ray. Semantics (reference path_mats.cpp, path_mis.cpp:16-149):

- path_mats: Russian roulette after 3 bounces, survival min(max throughput,
  0.99);
- path_mis: Russian roulette from the first vertex, survival clamped to
  [ε, 0.99]; the NEE contribution is scaled ×numLights with pdf/numLights;
  a discrete BSDF sample sets w_ems = 0, w_mats = 1; the envmap on a miss is
  MIS-weighted against its NEE pdf (the JAX package's balance heuristic).

`li_path_fused` renders either with the shading kernel of `csrc/scan.cu`
(`ops/cuda/scan.py`): per bounce one closest-hit launch, one shade launch
and, under path_mis, one any-hit launch of the shadow rays it wrote. The two
`li_path_*` functions are its plain reference.
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core.math import EPSILON, Ray, normalize
from optix_renderer_tpu_torch.integrators import common
from optix_renderer_tpu_torch.ops import bsdf as bsdf_ops
from optix_renderer_tpu_torch.ops import emitter as emitter_ops
from optix_renderer_tpu_torch.ops.bvh import BIG
from optix_renderer_tpu_torch.ops.cuda import scan as scan_shade
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData
from optix_renderer_tpu_torch.utils import tracing


def _segment(ray: Ray, ro, rd, bounce: int) -> Ray:
    """The first segment keeps the camera's near / far clip (perspective.cpp:
    10-31); later bounces are [ε, ∞)."""
    if bounce == 0:
        return Ray(o=ro, d=rd, mint=ray.mint, maxt=ray.maxt)
    return Ray(o=ro, d=rd, mint=torch.full_like(ray.mint, EPSILON),
               maxt=torch.full_like(ray.maxt, float("inf")))


def li_path_mats(scene: SceneData, config: RenderConfig, ray: Ray, sampler):
    n = ray.o.shape[0]
    dev = ray.o.device
    ro, rd = ray.o, ray.d
    t = torch.ones((n, 3), device=dev)
    L = torch.zeros((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    albedo = torch.zeros((n, 3), device=dev)
    normal = torch.zeros((n, 3), device=dev)
    s = sampler
    for bounce in range(config.max_depth):
        with tracing.span("scan.bounce", bounce=bounce):
            tracing.count_lanes(active)  # the lanes entering the bounce, and those alive
            with tracing.span("scan.intersect"):
                ctx = common.trace(scene, _segment(ray, ro, rd, bounce))
            hit = ctx.its.valid & active

            # miss → envmap, terminate
            L = L + t * common.miss_envmap(scene, rd, active & ~ctx.its.valid)
            active = active & ctx.its.valid

            if bounce == 0:
                albedo, normal = common.first_hit_aovs(scene, ctx)

            L = L + torch.where(hit[..., None], t * common.hit_emitter_radiance(scene, ctx, rd),
                                0.0)

            # Russian roulette after 3 bounces (path_mats.cpp:47-58)
            s, u_rr = smp.next_1d(s)
            succ = torch.clamp(torch.amax(t, dim=-1), max=0.99)
            if bounce >= 3:
                die = (u_rr > succ) & active
                t = torch.where(active[..., None], t / torch.clamp(succ, min=1e-12)[..., None], t)
                active = active & ~die

            # BSDF sampling
            wo_local = common.to_local(ctx, -normalize(rd))
            s, u2 = smp.next_2d(s)
            bs = bsdf_ops.sample_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local,
                                      ctx.its.uv, u2)
            t = torch.where(active[..., None], t * bs.weight, t)
            active = active & torch.any(torch.abs(t) > 1e-12, dim=-1)

            rd_new = common.to_world(ctx, bs.wo)
            ro = torch.where(active[..., None], ctx.its.p, ro)
            rd = torch.where(active[..., None], rd_new, rd)
    return L, albedo, normal, s


def li_path_mis(scene: SceneData, config: RenderConfig, ray: Ray, sampler):
    n = ray.o.shape[0]
    dev = ray.o.device
    n_lights = max(config.n_emitters, 1)
    ro, rd = ray.o, ray.d
    t = torch.ones((n, 3), device=dev)
    L = torch.zeros((n, 3), device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    pdf_mats_prev = torch.zeros(n, device=dev)
    prev_discrete = torch.zeros(n, dtype=torch.bool, device=dev)
    w_mats_prev = torch.ones(n, device=dev)
    albedo = torch.zeros((n, 3), device=dev)
    normal = torch.zeros((n, 3), device=dev)
    s = sampler
    for bounce in range(config.max_depth):
        with tracing.span("scan.bounce", bounce=bounce):
            tracing.count_lanes(active)  # the lanes entering the bounce, and those alive
            with tracing.span("scan.intersect"):
                ctx = common.trace(scene, _segment(ray, ro, rd, bounce))
            first = bounce == 0

            # miss → envmap, MIS-weighted against the NEE envmap pdf
            pdf_env_dir = emitter_ops.pdf_envmap_direction(scene, rd) / float(n_lights)
            denom_env = pdf_mats_prev + pdf_env_dir
            w_env = torch.where(denom_env > EPSILON,
                                pdf_mats_prev / torch.clamp(denom_env, min=1e-20), 1.0)
            w_env = torch.where(prev_discrete | first, 1.0, w_env)
            env = common.miss_envmap(scene, rd, active & ~ctx.its.valid)
            L = L + w_env[..., None] * t * env
            active = active & ctx.its.valid

            if first:
                albedo, normal = common.first_hit_aovs(scene, ctx)

            # emitter hit with the lazily computed w_mats (path_mis.cpp:51-56, 119-133)
            hit_em = active & (ctx.emitter_id >= 0)
            pdf_ems_here = emitter_ops.pdf_hit_emitter(
                scene, ctx.emitter_id, ro, ctx.its.p, ctx.frame.n, normalize(rd)) / float(n_lights)
            denom = pdf_mats_prev + pdf_ems_here
            w_mats = torch.where(denom > EPSILON, pdf_mats_prev / torch.clamp(denom, min=1e-20),
                                 w_mats_prev)
            w_mats = torch.where(prev_discrete | first, 1.0, w_mats)
            L = L + torch.where(hit_em[..., None],
                                w_mats[..., None] * t * common.hit_emitter_radiance(scene, ctx, rd),
                                0.0)

            # Russian roulette from the first vertex (path_mis.cpp:58-71)
            s, u_rr = smp.next_1d(s)
            succ = torch.clamp(torch.amax(t, dim=-1), EPSILON, 0.99)
            die = (u_rr > succ) & active
            t = torch.where(active[..., None], t / succ[..., None], t)
            active = active & ~die

            # NEE (path_mis.cpp:74-106)
            wo_local = common.to_local(ctx, -normalize(rd))
            s, u_pick = smp.next_1d(s)
            em_id = common.pick_emitter(scene, u_pick)
            s, u_ems = smp.next_3d(s)
            with tracing.span("scan.nee"):
                ems_contrib, pdf_ems, pdf_mat_at_ems, _ = common.nee(
                    scene, ctx, wo_local, em_id, u_ems, n_lights=n_lights)
            w_ems = torch.where(pdf_ems + pdf_mat_at_ems > EPSILON,
                                pdf_ems / torch.clamp(pdf_ems + pdf_mat_at_ems, min=1e-20), 0.0)

            # BSDF sampling (path_mis.cpp:108-133)
            s, u_mats = smp.next_2d(s)
            bs = bsdf_ops.sample_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local,
                                      ctx.its.uv, u_mats)
            w_ems = torch.where(bs.is_discrete, 0.0, w_ems)  # path_mis.cpp:135-140

            L = L + torch.where(active[..., None], w_ems[..., None] * t * ems_contrib, 0.0)
            t = torch.where(active[..., None], t * bs.weight, t)
            active = active & torch.any(torch.abs(t) > 1e-12, dim=-1)

            ro = torch.where(active[..., None], ctx.its.p, ro)
            rd = torch.where(active[..., None], common.to_world(ctx, bs.wo), rd)
            pdf_mats_prev, prev_discrete, w_mats_prev = bs.pdf, bs.is_discrete, w_mats
    return L, albedo, normal, s


def li_path_fused(scene: SceneData, config: RenderConfig, ray: Ray, sampler, sc, shade=None):
    """`li_path_mis` / `li_path_mats` (by `config.integrator`) with each
    bounce's shading in one launch of `shade` (by default the kernel,
    `scan_shade.shade`; or its plain version `scan_shade.shade_ref`) over
    the lane state of `ops/cuda/scan.py: Lanes`;
    `sc` is the scene's `ShadeScene` (`scan_shade.prepare`). Returns what
    they return; the sampler's streams match theirs on the lanes still alive."""
    shade = shade or scan_shade.shade
    geom = scene.geometry
    lanes = scan_shade.Lanes.start(ray, sampler)
    n, dev = ray.o.shape[0], ray.o.device
    eps = torch.full((n,), EPSILON, device=dev)
    big = torch.full((n,), BIG, device=dev)
    occ = None
    for bounce in range(config.max_depth):
        with tracing.span("scan.bounce", bounce=bounce):
            tracing.count_lanes(lanes.active)  # the lanes entering the bounce, and those alive
            if bounce == 0:  # the camera's near / far clip, then [ε, ∞)
                mint, cut = ray.mint, torch.where(torch.isinf(ray.maxt), BIG, ray.maxt)
            else:
                mint, cut = eps, big
            with tracing.span("scan.intersect"):
                hits = scan_shade.winners(geom, lanes, mint, cut)
            with tracing.span("scan.shade"):
                shade(sc, lanes, bounce, hits, occ)
            if sc.mis:
                with tracing.span("scan.nee"):
                    occ = scan_shade.occluders(geom, lanes)
    if sc.mis:
        shade(sc, lanes, config.max_depth, None, occ, fold_only=True)
    return lanes.L, lanes.albedo, lanes.normal, lanes.sampler()
