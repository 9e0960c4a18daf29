"""Wavefront path regeneration: a persistent lane pool that refills the
lanes of finished paths between bounces.

Counterpart of `optix_renderer_tpu/render/wavefront.py`. The scan path
(`render.scan_step`, `integrators/path.py`) takes every lane through all
`max_depth` bounces with masks, though in a Cornell box most paths end
after about three. Here a fixed pool of N lanes each carries one live path;
when a path ends (a miss, Russian roulette, zero throughput, the depth
cap) its radiance is splatted into the film and the lane takes the next
(pixel, sample) work item from a counter on the device. Work items are
pixel-major, so a refill is a run of neighbouring pixels.

Each path's arithmetic is the scan path's: the same sampler stream per
(pixel, sample), the same draws in the same order, the same bounce body
with a per-lane bounce counter in place of the loop index. Only the lane
a path runs on changes, so each path's radiance and AOVs are bit for bit
the scan path's, and the films differ in the order of their additions
only. With the box filter at 2 spp a pixel adds two samples of weight 1,
which commute, except where pixel + jitter rounds up to the next pixel's
edge (a jitter within an ulp of 1): that pixel then adds three. Intersections go through
`integrators/common.trace`: `isect_brute` / `isect_bvh` of `csrc/isect.cu`
on a CUDA device, their plain versions on the CPU.

Checkpoints and resume stay with the scan path (a snapshot would lose the
paths in flight); `render.render(..., wavefront=True)` dispatches here.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from optix_renderer_tpu_torch.core import rng
from optix_renderer_tpu_torch.core.math import EPSILON, Ray, normalize
from optix_renderer_tpu_torch.integrators import common
from optix_renderer_tpu_torch.ops import bsdf as bsdf_ops
from optix_renderer_tpu_torch.ops import camera as camera_ops
from optix_renderer_tpu_torch.ops import emitter as emitter_ops
from optix_renderer_tpu_torch.render import film
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.render.render import _layers_out, preprocess, resolve_device
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData
from optix_renderer_tpu_torch.utils import tracing

# integrators with a wavefront bounce body; the others keep the scan path
WAVEFRONT_INTEGRATORS = ("path_mats", "path_mis")


class PathState(NamedTuple):
    """Each lane's live path (the reference's per-thread `RadiancePrd`, with
    the MIS carry of `integrators/path.py: li_path_mis`) and the work
    counter, all on one device."""

    active: torch.Tensor  # [N] bool: the lane holds a live path
    bounce: torch.Tensor  # [N] int64: bounces done
    pos: torch.Tensor  # [N,2] film position (pixel + jitter)
    ro: torch.Tensor  # [N,3]
    rd: torch.Tensor  # [N,3]
    cam_mint: torch.Tensor  # [N] the camera ray's near clip
    cam_maxt: torch.Tensor  # [N] and far clip
    tput: torch.Tensor  # [N,3]
    L: torch.Tensor  # [N,3]
    albedo: torch.Tensor  # [N,3]
    normal: torch.Tensor  # [N,3]
    pdf_mats_prev: torch.Tensor  # [N]
    prev_discrete: torch.Tensor  # [N] bool
    w_mats_prev: torch.Tensor  # [N]
    sampler: smp.Sampler
    next_work: torch.Tensor  # [] int64: the next work item to hand out


def init_state(n: int, seed: int = 0, device="cuda") -> PathState:
    """A pool of `n` idle lanes on `device`."""
    dev = torch.device(device)

    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return PathState(
        active=z(n, torch.bool),
        bounce=z(n, torch.int64),
        pos=z((n, 2)),
        ro=z((n, 3)),
        rd=z((n, 3)),
        cam_mint=z(n),
        cam_maxt=z(n),
        tput=torch.ones((n, 3), device=dev),
        L=z((n, 3)),
        albedo=z((n, 3)),
        normal=z((n, 3)),
        pdf_mats_prev=z(n),
        prev_discrete=z(n, torch.bool),
        w_mats_prev=torch.ones(n, device=dev),
        sampler=smp.make_sampler(z(n, torch.int64), z(n, torch.int64), seed),
        next_work=z((), torch.int64),
    )


def _refill(state: PathState, scene: SceneData, config: RenderConfig, total_work: int,
            s2c: torch.Tensor | None = None) -> PathState:
    """Give the next work items to the free lanes and spawn their camera
    rays. Work item w is pixel w % n_pix, sample w // n_pix; its sampler
    stream is `render._round_layers`'s: `make_sampler(pixel, sample)`, then
    the 2D jitter and the 2D aperture draws. `s2c` as in
    `camera_ops.sample_ray`."""
    n = state.active.shape[0]
    n_pix = config.width * config.height
    free = ~state.active
    rank = torch.cumsum(free.to(torch.int64), dim=0) - 1
    w_id = state.next_work + rank
    spawn = free & (w_id < total_work)

    pix = torch.where(spawn, w_id % n_pix, 0)
    sample_idx = torch.where(spawn, w_id // n_pix, 0)
    s = smp.make_sampler(pix, sample_idx, seed=config.seed)
    s, jitter = smp.next_2d(s)
    s, aperture = smp.next_2d(s)
    px = (pix % config.width).to(torch.float32)
    py = (pix // config.width).to(torch.float32)
    pos = torch.stack([px, py], dim=-1) + jitter
    ray, _ = camera_ops.sample_ray(scene.camera, config.width, config.height, pos, aperture,
                                   s2c=s2c)

    sp = spawn[:, None]
    sampler = smp.Sampler(state=rng.Pcg32State(*(
        torch.where(spawn, new, old) for new, old in zip(s.state, state.sampler.state))))
    return PathState(
        active=state.active | spawn,
        bounce=torch.where(spawn, 0, state.bounce),
        pos=torch.where(sp, pos, state.pos),
        ro=torch.where(sp, ray.o, state.ro),
        rd=torch.where(sp, ray.d, state.rd),
        cam_mint=torch.where(spawn, ray.mint, state.cam_mint),
        cam_maxt=torch.where(spawn, ray.maxt, state.cam_maxt),
        tput=torch.where(sp, 1.0, state.tput),
        L=torch.where(sp, 0.0, state.L),
        albedo=torch.where(sp, 0.0, state.albedo),
        normal=torch.where(sp, 0.0, state.normal),
        pdf_mats_prev=torch.where(spawn, 0.0, state.pdf_mats_prev),
        prev_discrete=state.prev_discrete & ~spawn,
        w_mats_prev=torch.where(spawn, 1.0, state.w_mats_prev),
        sampler=sampler,
        next_work=torch.clamp(state.next_work + free.sum(), max=total_work + n),
    )


def _bounce(state: PathState, scene: SceneData, config: RenderConfig) -> PathState:
    """One bounce of every lane: the body of `li_path_mats` / `li_path_mis`
    (`integrators/path.py`), with the lane's `bounce` in place of the loop
    index, the same expressions and the same draws, so each path's radiance
    and AOVs are bit for bit the scan path's."""
    mis = config.integrator == "path_mis"
    n_lights = max(config.n_emitters, 1)
    active = state.active
    first = state.bounce == 0
    ro, rd, t, L, s = state.ro, state.rd, state.tput, state.L, state.sampler
    pdf_mats_prev, prev_discrete = state.pdf_mats_prev, state.prev_discrete

    # the first segment keeps the camera's near / far clip, later ones [ε, ∞)
    r = Ray(o=ro, d=rd, mint=torch.where(first, state.cam_mint, EPSILON),
            maxt=torch.where(first, state.cam_maxt, float("inf")))
    ctx = common.trace(scene, r)

    if mis:
        # miss → envmap, MIS-weighted against the NEE envmap pdf
        pdf_env_dir = emitter_ops.pdf_envmap_direction(scene, rd) / float(n_lights)
        denom_env = pdf_mats_prev + pdf_env_dir
        w_env = torch.where(denom_env > EPSILON,
                            pdf_mats_prev / torch.clamp(denom_env, min=1e-20), 1.0)
        w_env = torch.where(prev_discrete | first, 1.0, w_env)
        env = common.miss_envmap(scene, rd, active & ~ctx.its.valid)
        L = L + w_env[..., None] * t * env
    else:
        hit = ctx.its.valid & active
        L = L + t * common.miss_envmap(scene, rd, active & ~ctx.its.valid)
    active = active & ctx.its.valid

    a0, n0 = common.first_hit_aovs(scene, ctx)
    albedo = torch.where(first[..., None], a0, state.albedo)
    normal = torch.where(first[..., None], n0, state.normal)

    if mis:
        # emitter hit with the lazily computed w_mats
        hit_em = active & (ctx.emitter_id >= 0)
        pdf_ems_here = emitter_ops.pdf_hit_emitter(
            scene, ctx.emitter_id, ro, ctx.its.p, ctx.frame.n, normalize(rd)) / float(n_lights)
        denom = pdf_mats_prev + pdf_ems_here
        w_mats = torch.where(denom > EPSILON, pdf_mats_prev / torch.clamp(denom, min=1e-20),
                             state.w_mats_prev)
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
        # comes on every bounce, as in the scan
        s, u_rr = smp.next_1d(s)
        succ = torch.clamp(torch.amax(t, dim=-1), max=0.99)
        rr_on = state.bounce >= 3
        die = rr_on & (u_rr > succ) & active
        t = torch.where((rr_on & active)[..., None],
                        t / torch.clamp(succ, min=1e-12)[..., None], t)
        active = active & ~die

        wo_local = common.to_local(ctx, -normalize(rd))
        s, u2 = smp.next_2d(s)
        bs = bsdf_ops.sample_bsdf(scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local,
                                  ctx.its.uv, u2)
        w_mats_prev = state.w_mats_prev

    t = torch.where(active[..., None], t * bs.weight, t)
    active = active & torch.any(torch.abs(t) > 1e-12, dim=-1)
    # the depth cap: the scan stops running bounces; here the lane ends and
    # takes new work
    active = active & (state.bounce + 1 < config.max_depth)

    ro = torch.where(active[..., None], ctx.its.p, ro)
    rd = torch.where(active[..., None], common.to_world(ctx, bs.wo), rd)
    return state._replace(
        active=active, bounce=state.bounce + 1, ro=ro, rd=rd, tput=t, L=L, albedo=albedo,
        normal=normal, pdf_mats_prev=pdf_mats_prev, prev_discrete=prev_discrete,
        w_mats_prev=w_mats_prev, sampler=s)


def wavefront_iter(acc: torch.Tensor, state: PathState, scene: SceneData, config: RenderConfig,
                   total_work: int, s2c: torch.Tensor | None = None):
    """Refill, one bounce, then splat the paths that ended into `acc`
    [3,H,W,4] in place. Returns (state, n_active), the live lanes' count a
    tensor on the device: nothing here waits for the device."""
    state = _refill(state, scene, config, total_work, s2c)
    was_active = state.active
    state = _bounce(state, scene, config)
    term = was_active & ~state.active
    # a dead lane's NaN / Inf must not poison the film
    L = torch.nan_to_num(state.L, nan=0.0, posinf=0.0, neginf=0.0)
    film.splat_(acc, config.rfilter, state.pos, torch.stack([L, state.albedo, state.normal]),
                mask=term)
    return state, state.active.sum()


@tracing.traced("render")
def render_wavefront(
    scene: SceneData,
    config: RenderConfig,
    sample_count: int | None = None,
    n_lanes: int = 1 << 19,
    verbose: bool = False,
    preview_every_iters: int = 0,
    preview_callback=None,
    acc: torch.Tensor | None = None,
    sync_every: int = 8,
    *,
    device="cuda",
) -> dict[str, np.ndarray]:
    """A whole render by path regeneration; the output of `render.render`.

    The host reads the work counter and the live lanes' count once every
    `sync_every` iterations; `acc` [3,H,W,4] on `device`, when given, is
    added into in place. The scene moves to `device` once."""
    if config.integrator not in WAVEFRONT_INTEGRATORS:
        raise ValueError(f"no wavefront bounce body for '{config.integrator}'; "
                         f"it has {WAVEFRONT_INTEGRATORS}")
    with tracing.span("render.dispatch"):
        device = resolve_device(device)
        scene = preprocess(scene, config, device).to(device)
        spp = sample_count if sample_count is not None else config.sample_count
        w, h = config.width, config.height
        n_pix = w * h
        total = n_pix * spp
        assert total < 2**31, "work items are numbered in int32, as in the JAX package"
        n = min(n_lanes, total)

        if acc is None:
            acc = torch.zeros((3, h, w, 4), dtype=torch.float32, device=device)
        state = init_state(n, seed=config.seed, device=device)
        s2c = camera_ops.sample_to_camera_matrix(scene.camera.to("cpu"), w, h).to(device)

    # a hard bound: every lane retires a work item within max_depth iterations
    max_iters = (total // n + 2) * config.max_depth + config.max_depth + 4
    t0 = time.time()
    it = 0
    while it < max_iters:
        for _ in range(sync_every):
            state, n_active = wavefront_iter(acc, state, scene, config, total, s2c)
            it += 1
        started, na = torch.stack([state.next_work, n_active]).tolist()
        started = min(started, total)
        done_work = started >= total
        if verbose:
            print(f"  wavefront iter {it}: ~{started / n_pix:.1f}/{spp} spp started, "
                  f"{na} lanes live ({time.time() - t0:.1f}s)")
        if preview_every_iters and preview_callback and it % preview_every_iters < sync_every:
            preview_callback(_layers_out(acc), started // n_pix)
        if done_work and na == 0:
            break

    out = _layers_out(acc)
    # where the bound tripped with work still queued, the samples done
    out["spp_done"] = spp if (done_work and na == 0) else started // n_pix
    return out
