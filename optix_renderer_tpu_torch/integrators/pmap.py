"""Photon-mapping integrator (src/integrators/photonmapper.cpp Li, :156-267).

Counterpart of `optix_renderer_tpu/integrators/pmap.py`. Camera rays walk by
BSDF sampling until the first diffuse surface, where the path ends with a
photon-density estimate (`ops/photon.py: estimate_radiance`); specular
chains (mirror, dielectric, microfacet) keep bouncing under Russian
roulette. Emitter hits and envmap misses add up along the way. The JAX scan
over bounces is a Python loop over the whole wavefront.

The JAX package estimates the radiance on every lane at every bounce and
keeps it where the lane gathers; here only the lanes that gather are
estimated, and their results are written back in place, which gives the
same film and never casts a missed lane's infinite point to a cell.

The photon map is built once per render by `render.preprocess` (the
`Integrator::preprocess` analog, render.cpp:272) and carried in
`scene.photons`.
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core.math import Frame, normalize
from optix_renderer_tpu_torch.integrators import common
from optix_renderer_tpu_torch.integrators.path import _segment
from optix_renderer_tpu_torch.ops import bsdf as bsdf_ops
from optix_renderer_tpu_torch.ops import photon as photon_ops
from optix_renderer_tpu_torch.ops.intersect import Interaction
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData


def _gather(scene: SceneData, ctx: common.ShadingCtx, wo_local, lanes) -> torch.Tensor:
    """The photon estimate [N,3]: computed on the `lanes` [N] bool that gather,
    zero elsewhere."""
    est = torch.zeros_like(wo_local)
    idx = torch.nonzero(lanes).reshape(-1)
    if idx.numel() == 0:
        return est

    def take(a):
        return torch.index_select(a, 0, idx)

    its = Interaction(*(take(a) for a in ctx.its))
    sub = common.ShadingCtx(its=its, frame=Frame(*(take(a) for a in ctx.frame)),
                            bsdf_id=take(ctx.bsdf_id), emitter_id=take(ctx.emitter_id))
    return est.index_copy_(0, idx, photon_ops.estimate_radiance(scene.photons, scene, sub,
                                                                take(wo_local)))


def li_photonmapper(scene: SceneData, config: RenderConfig, ray, sampler):
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
        ctx = common.trace(scene, _segment(ro, rd, ray.mint, ray.maxt, bounce))

        # miss → envmap (photonmapper.cpp:170-180)
        L = L + t * common.miss_envmap(scene, rd, active & ~ctx.its.valid)
        active = active & ctx.its.valid

        if bounce == 0:
            albedo, normal = common.first_hit_aovs(scene, ctx)

        # emitter hit (photonmapper.cpp:187-192)
        L = L + torch.where(active[..., None], t * common.hit_emitter_radiance(scene, ctx, rd),
                            0.0)

        # diffuse → photon gather, and the path ends (photonmapper.cpp:194-236)
        is_diffuse = photon_ops.is_diffuse(scene, ctx.bsdf_id)
        gather_here = active & is_diffuse
        wo_local = common.to_local(ctx, -normalize(rd))
        est = _gather(scene, ctx, wo_local, gather_here)
        L = L + torch.where(gather_here[..., None], t * est, 0.0)
        active = active & ~is_diffuse

        # Russian roulette after 3 bounces (photonmapper.cpp:238-252)
        s, u_rr = smp.next_1d(s)
        if bounce >= 3:
            succ = torch.clamp(torch.amax(t, dim=-1), max=0.99)
            die = (u_rr > succ) & active
            t = torch.where(active[..., None], t / torch.clamp(succ, min=1e-12)[..., None], t)
            active = active & ~die

        # continue by BSDF sampling (photonmapper.cpp:254-266)
        s, u2 = smp.next_2d(s)
        bs = bsdf_ops.sample_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local,
                                  ctx.its.uv, u2)
        t = torch.where(active[..., None], t * bs.weight, t)
        active = active & torch.any(torch.abs(t) > 1e-12, dim=-1)
        ro = torch.where(active[..., None], ctx.its.p, ro)
        rd = torch.where(active[..., None], common.to_world(ctx, bs.wo), rd)
    return L, albedo, normal, s
