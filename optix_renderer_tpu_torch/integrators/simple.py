"""Single-bounce integrators: normals, av, the direct family, preview, envmaptester.

Counterpart of `optix_renderer_tpu/integrators/simple.py` (the reference
normals, av, direct, direct_ems, direct_mats, direct_mis, PreviewIntegrator
and EnvMapTester). Every lane runs every branch and selects by mask. The
sampler is drawn in the JAX package's order, so each (pixel, sample) stream
gives the same numbers: `direct` / `direct_ems` draw one `next_3d` per
emitter; `direct_mis` draws 1d, 3d, then 2d; `preview` 1d, then 3d;
`direct_mats` and `av` one 2d.
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core import warp
from optix_renderer_tpu_torch.core.math import EPSILON, Ray, normalize
from optix_renderer_tpu_torch.integrators import common
from optix_renderer_tpu_torch.ops import bsdf as bsdf_ops
from optix_renderer_tpu_torch.ops import emitter as emitter_ops
from optix_renderer_tpu_torch.ops.intersect import occluded
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData


def _env_where_missed(scene, ctx, ray, L):
    """L on lanes that hit, the envmap along the ray on lanes that missed."""
    env = common.miss_envmap(scene, ray.d, ~ctx.its.valid)
    return torch.where(ctx.its.valid[..., None], L, env)


def _secondary(ray_o, d, n: int) -> Ray:
    dev = ray_o.device
    return Ray(o=ray_o, d=d, mint=torch.full((n,), EPSILON, device=dev),
               maxt=torch.full((n,), float("inf"), device=dev))


def li_normals(scene: SceneData, config: RenderConfig, ray: Ray, sampler):
    """Shading-normal visualization (normals.cpp:16-36): |n| as color."""
    ctx = common.trace(scene, ray)
    albedo, normal = common.first_hit_aovs(scene, ctx)
    return _env_where_missed(scene, ctx, ray, torch.abs(ctx.frame.n)), albedo, normal, sampler


def li_av(scene: SceneData, config: RenderConfig, ray: Ray, sampler):
    """Average visibility / ambient occlusion (av.cpp:18-43)."""
    length = config.iprop("length", 1e30)
    ctx = common.trace(scene, ray)
    albedo, normal = common.first_hit_aovs(scene, ctx)
    sampler, u2 = smp.next_2d(sampler)
    d_world = common.to_world(ctx, warp.square_to_uniform_hemisphere(u2))
    shadow = Ray(o=ctx.its.p, d=d_world, mint=torch.full_like(ray.mint, EPSILON),
                 maxt=torch.full_like(ray.mint, length))
    blocked = occluded(scene.geometry, shadow)
    vis = torch.where(ctx.its.valid, torch.where(blocked, 0.0, 1.0), 1.0)
    return vis[..., None].expand(-1, 3).contiguous(), albedo, normal, sampler


def _direct_all_lights(scene, config, ray, sampler, add_hit_emitter: bool):
    """Shared body of `direct` / `direct_ems`: one NEE try at every light
    (direct.cpp:23-50, direct_ems.cpp:28-57)."""
    ctx = common.trace(scene, ray)
    albedo, normal = common.first_hit_aovs(scene, ctx)
    n = ray.o.shape[0]
    L = torch.zeros((n, 3), device=ray.o.device)
    if add_hit_emitter:
        L = L + torch.where(ctx.its.valid[..., None],
                            common.hit_emitter_radiance(scene, ctx, ray.d), 0.0)
    wo_local = common.to_local(ctx, normalize(ray.o - ctx.its.p))
    for e in range(config.n_emitters):
        sampler, u3 = smp.next_3d(sampler)
        em_id = torch.full((n,), e, dtype=torch.int32, device=ray.o.device)
        contrib, _, _, _ = common.nee(scene, ctx, wo_local, em_id, u3, n_lights=1, abs_cos=True)
        L = L + contrib
    return _env_where_missed(scene, ctx, ray, L), albedo, normal, sampler


def li_direct(scene, config, ray, sampler):
    return _direct_all_lights(scene, config, ray, sampler, add_hit_emitter=False)


def li_direct_ems(scene, config, ray, sampler):
    return _direct_all_lights(scene, config, ray, sampler, add_hit_emitter=True)


def li_direct_mats(scene, config, ray, sampler):
    """BSDF-sampling direct illumination (direct_mats.cpp)."""
    ctx = common.trace(scene, ray)
    albedo, normal = common.first_hit_aovs(scene, ctx)
    L = torch.where(ctx.its.valid[..., None], common.hit_emitter_radiance(scene, ctx, ray.d), 0.0)
    wo_local = common.to_local(ctx, -normalize(ray.d))
    sampler, u2 = smp.next_2d(sampler)
    bs = bsdf_ops.sample_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local, ctx.its.uv, u2)
    nonzero = torch.any(torch.abs(bs.weight) > EPSILON, dim=-1) & ctx.its.valid
    ray2 = _secondary(ctx.its.p, common.to_world(ctx, bs.wo), ray.o.shape[0])
    ctx2 = common.trace(scene, ray2)
    hit_em = common.hit_emitter_radiance(scene, ctx2, ray2.d)
    secondary = torch.where(
        (nonzero & ctx2.its.valid)[..., None], hit_em * bs.weight,
        common.miss_envmap(scene, ray2.d, nonzero & ~ctx2.its.valid) * bs.weight)
    return _env_where_missed(scene, ctx, ray, L + secondary), albedo, normal, sampler


def li_direct_mis(scene, config, ray, sampler):
    """Balance-heuristic MIS direct illumination (direct_mis.cpp:16-150)."""
    n_lights = max(config.n_emitters, 1)
    ctx = common.trace(scene, ray)
    albedo, normal = common.first_hit_aovs(scene, ctx)
    L = torch.where(ctx.its.valid[..., None], common.hit_emitter_radiance(scene, ctx, ray.d), 0.0)
    wo_local = common.to_local(ctx, -normalize(ray.d))

    # EMS side
    sampler, u1 = smp.next_1d(sampler)
    em_id = common.pick_emitter(scene, u1)
    sampler, u3 = smp.next_3d(sampler)
    ems_contrib, pdf_ems, pdf_mat_at_ems, _ = common.nee(
        scene, ctx, wo_local, em_id, u3, n_lights=n_lights, abs_cos=False)
    w_ems = torch.where(pdf_ems + pdf_mat_at_ems > EPSILON,
                        pdf_ems / torch.clamp(pdf_ems + pdf_mat_at_ems, min=1e-20), 0.0)

    # MATS side
    sampler, u2 = smp.next_2d(sampler)
    bs = bsdf_ops.sample_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local, ctx.its.uv, u2)
    nonzero = torch.any(torch.abs(bs.weight) > EPSILON, dim=-1) & ctx.its.valid
    ray2 = _secondary(ctx.its.p, common.to_world(ctx, bs.wo), ray.o.shape[0])
    ctx2 = common.trace(scene, ray2)
    hit_is_em = ctx2.its.valid & (ctx2.emitter_id >= 0) & nonzero
    env_miss = nonzero & ~ctx2.its.valid
    mats_contrib = torch.where(
        hit_is_em[..., None], bs.weight * common.hit_emitter_radiance(scene, ctx2, ray2.d),
        common.miss_envmap(scene, ray2.d, env_miss) * bs.weight)
    # env misses are weighted like emitter hits, against the envmap's NEE pdf
    # (the JAX package's deviation from direct_mis.cpp, which drops the term)
    pdf_mat = torch.where(hit_is_em | env_miss, bs.pdf, 0.0)
    pdf_ems_at_hit = emitter_ops.pdf_hit_emitter(
        scene, ctx2.emitter_id, ctx.its.p, ctx2.its.p, ctx2.frame.n, normalize(ray2.d)
    ) / float(n_lights)
    pdf_env = emitter_ops.pdf_envmap_direction(scene, ray2.d) / float(n_lights)
    pdf_ems_at_hit = torch.where(hit_is_em, pdf_ems_at_hit, torch.where(env_miss, pdf_env, 0.0))
    w_mat = torch.where(pdf_mat + pdf_ems_at_hit > EPSILON,
                        pdf_mat / torch.clamp(pdf_mat + pdf_ems_at_hit, min=1e-20), 0.0)
    # discrete BSDFs: MATS weight 1 (as path_mis.cpp:135-140)
    w_mat = torch.where(bs.is_discrete & nonzero, 1.0, w_mat)
    w_ems = torch.where(bs.is_discrete, 0.0, w_ems)

    L = L + w_ems[..., None] * ems_contrib + w_mat[..., None] * mats_contrib
    return _env_where_missed(scene, ctx, ray, L), albedo, normal, sampler


def li_preview(scene, config, ray, sampler):
    """Fast one-light preview with AOVs (PreviewIntegrator.cpp:17-60)."""
    n_lights = max(config.n_emitters, 1)
    ctx = common.trace(scene, ray)
    albedo, normal = common.first_hit_aovs(scene, ctx)
    wo_local = common.to_local(ctx, normalize(ray.o - ctx.its.p))
    sampler, u1 = smp.next_1d(sampler)
    em_id = common.pick_emitter(scene, u1)
    sampler, u3 = smp.next_3d(sampler)
    contrib, _, _, _ = common.nee(scene, ctx, wo_local, em_id, u3, n_lights=n_lights,
                                  abs_cos=True)
    L = torch.abs(ctx.frame.n) if config.n_emitters == 0 else contrib
    return _env_where_missed(scene, ctx, ray, L), albedo, normal, sampler


def li_envmaptester(scene, config, ray, sampler):
    """Debug envmap lookup (EnvMapTester.cpp): the envmap along each ray."""
    L = emitter_ops.eval_envmap(scene, normalize(ray.d))
    z = torch.zeros_like(L)
    return L, z, z, sampler
