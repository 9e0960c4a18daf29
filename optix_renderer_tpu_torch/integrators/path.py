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

Both loop over one body, `path_bounce`, which the wavefront
(`render/wavefront.py`) also runs with a per-lane bounce counter.

`li_path_fused` renders either with the shading kernel of `csrc/scan.cu`
(`ops/cuda/scan.py`): per bounce one closest-hit launch, one shade launch
and, under path_mis, one any-hit launch of the shadow rays it wrote. The two
`li_path_*` functions are its plain reference.
"""

from __future__ import annotations

from typing import NamedTuple

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


class PathLanes(NamedTuple):
    """Each lane's path between bounces: its ray and the camera ray's clip,
    throughput, radiance, the first hit's AOVs, the MIS carry and the
    sampler; the wavefront's lane pool holds one (`render/wavefront.py`)."""

    ro: torch.Tensor  # [N,3]
    rd: torch.Tensor  # [N,3]
    cam_mint: torch.Tensor  # [N] the camera ray's near clip
    cam_maxt: torch.Tensor  # [N] and far clip
    tput: torch.Tensor  # [N,3]
    L: torch.Tensor  # [N,3]
    albedo: torch.Tensor  # [N,3]
    normal: torch.Tensor  # [N,3]
    active: torch.Tensor  # [N] bool
    pdf_mats_prev: torch.Tensor  # [N]
    prev_discrete: torch.Tensor  # [N] bool
    w_mats_prev: torch.Tensor  # [N]
    sampler: smp.Sampler

    @classmethod
    def start(cls, ray: Ray, sampler) -> "PathLanes":
        """Every lane at the camera ray, alive, before its first bounce."""
        n, dev = ray.o.shape[0], ray.o.device
        v0, v1 = torch.zeros((n, 3), device=dev), torch.ones((n, 3), device=dev)
        return cls(ray.o, ray.d, ray.mint, ray.maxt, v1, v0, v0.clone(), v0.clone(),
                   torch.ones(n, dtype=torch.bool, device=dev), torch.zeros(n, device=dev),
                   torch.zeros(n, dtype=torch.bool, device=dev), torch.ones(n, device=dev),
                   sampler)


def _where(cond, new, old):
    """`new` where the bounce test `cond` holds, else `old`: a bool (an int
    bounce) picks one, a per-lane mask picks per lane; the same bits."""
    if isinstance(cond, bool):
        return new if cond else old
    return torch.where(cond[..., None] if new.dim() > cond.dim() else cond, new, old)


def _segment(ro, rd, mint, maxt, bounce) -> Ray:
    """The bounce's ray: the first segment keeps the camera's near / far clip
    (`mint`, `maxt`; perspective.cpp:10-31), later bounces are [ε, ∞)."""
    first = bounce == 0
    return Ray(o=ro, d=rd, mint=_where(first, mint, torch.full_like(mint, EPSILON)),
               maxt=_where(first, maxt, torch.full_like(maxt, float("inf"))))


def path_bounce(scene: SceneData, config: RenderConfig, st: PathLanes, bounce,
                mis: bool) -> PathLanes:
    """One bounce of every lane of `st` → `st` advanced, under path_mis
    (`mis`) or path_mats. `bounce` is the bounces done: an int in the loop
    of `li_path_*`, a per-lane int64 tensor in the wavefront; a lane draws
    and computes the same from either, to the bit."""
    n_lights = max(config.n_emitters, 1)
    ro, rd, t, L, s, active = st.ro, st.rd, st.tput, st.L, st.sampler, st.active
    pdf_mats_prev, prev_discrete, w_mats_prev = st.pdf_mats_prev, st.prev_discrete, st.w_mats_prev
    first = bounce == 0
    with tracing.span("scan.intersect"):
        ctx = common.trace(scene, _segment(ro, rd, st.cam_mint, st.cam_maxt, bounce))
    hit = ctx.its.valid & active

    # miss → envmap, terminate; under path_mis MIS-weighted against the NEE envmap pdf
    env = common.miss_envmap(scene, rd, active & ~ctx.its.valid)
    if mis:
        pdf_env_dir = emitter_ops.pdf_envmap_direction(scene, rd) / float(n_lights)
        denom_env = pdf_mats_prev + pdf_env_dir
        w_env = torch.where(denom_env > EPSILON,
                            pdf_mats_prev / torch.clamp(denom_env, min=1e-20), 1.0)
        w_env = torch.where(prev_discrete | first, 1.0, w_env)
        L = L + w_env[..., None] * t * env
    else:
        L = L + t * env
    active = hit

    albedo, normal = st.albedo, st.normal
    if first is not False:
        a0, n0 = common.first_hit_aovs(scene, ctx)
        albedo, normal = _where(first, a0, albedo), _where(first, n0, normal)

    if mis:
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
        pdf_mats_prev, prev_discrete, w_mats_prev = bs.pdf, bs.is_discrete, w_mats
    else:
        L = L + torch.where(hit[..., None], t * common.hit_emitter_radiance(scene, ctx, rd), 0.0)

        # Russian roulette after 3 bounces (path_mats.cpp:47-58); the draw
        # comes on every bounce
        s, u_rr = smp.next_1d(s)
        succ = torch.clamp(torch.amax(t, dim=-1), max=0.99)
        late = bounce >= 3
        if late is not False:
            rr = active & late
            t = torch.where(rr[..., None], t / torch.clamp(succ, min=1e-12)[..., None], t)
            active = active & ~(rr & (u_rr > succ))

        # BSDF sampling
        wo_local = common.to_local(ctx, -normalize(rd))
        s, u2 = smp.next_2d(s)
        bs = bsdf_ops.sample_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local,
                                  ctx.its.uv, u2)

    t = torch.where(active[..., None], t * bs.weight, t)
    active = active & torch.any(torch.abs(t) > 1e-12, dim=-1)
    ro = torch.where(active[..., None], ctx.its.p, ro)
    rd = torch.where(active[..., None], common.to_world(ctx, bs.wo), rd)
    return st._replace(ro=ro, rd=rd, tput=t, L=L, albedo=albedo, normal=normal, active=active,
                       pdf_mats_prev=pdf_mats_prev, prev_discrete=prev_discrete,
                       w_mats_prev=w_mats_prev, sampler=s)


def _li_path(scene: SceneData, config: RenderConfig, ray: Ray, sampler, mis: bool):
    st = PathLanes.start(ray, sampler)
    for bounce in range(config.max_depth):
        with tracing.span("scan.bounce", bounce=bounce):
            tracing.count_lanes(st.active)  # the lanes entering the bounce, and those alive
            st = path_bounce(scene, config, st, bounce, mis)
    return st.L, st.albedo, st.normal, st.sampler


def li_path_mats(scene: SceneData, config: RenderConfig, ray: Ray, sampler):
    return _li_path(scene, config, ray, sampler, mis=False)


def li_path_mis(scene: SceneData, config: RenderConfig, ray: Ray, sampler):
    return _li_path(scene, config, ray, sampler, mis=True)


def li_path_fused(scene: SceneData, config: RenderConfig, ray: Ray, sampler, sc, shade=None):
    """`li_path_mis` / `li_path_mats` (by `config.integrator`) with each
    bounce's shading in one launch of `shade` (by default the kernel,
    `scan_shade.shade`; or its plain version `scan_shade.shade_ref`) over
    the lane state of `ops/cuda/scan.py: Lanes`; `sc` is the scene's
    `ShadeScene`, as the rule `render/scan_graph.py: shade_scene` gives it
    for a round that takes the kernel. Returns what
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
