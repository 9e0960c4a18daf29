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
(`integrators/path.py: path_bounce`) with a per-lane bounce counter in
place of the loop index. Only the lane a path runs on changes, so each
path's radiance and AOVs are bit for bit the scan path's, and the films
differ in the order of their additions only. With the box filter at 2
spp a pixel adds two samples of weight 1, which commute, except where
pixel + jitter rounds up to the next pixel's edge (a jitter within an ulp
of 1): that pixel then adds three. Intersections go through
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
from optix_renderer_tpu_torch.core.math import Ray
from optix_renderer_tpu_torch.integrators import path as path_int
from optix_renderer_tpu_torch.ops import camera as camera_ops
from optix_renderer_tpu_torch.render import film
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.render.render import _layers_out, preprocess, resolve_device
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData
from optix_renderer_tpu_torch.utils import tracing

# integrators with a wavefront bounce body; the others keep the scan path
WAVEFRONT_INTEGRATORS = ("path_mats", "path_mis")


class PathState(NamedTuple):
    """The lane pool on one device: each lane's live path (the reference's
    per-thread `RadiancePrd` with the MIS carry), its bounce counter and
    film position, and the work counter."""

    path: path_int.PathLanes  # `active`: the lane holds a live path
    bounce: torch.Tensor  # [N] int64: bounces done
    pos: torch.Tensor  # [N,2] film position (pixel + jitter)
    next_work: torch.Tensor  # [] int64: the next work item to hand out


def init_state(n: int, seed: int = 0, device="cuda") -> PathState:
    """A pool of `n` idle lanes on `device`."""
    dev = torch.device(device)
    z, zi = torch.zeros(n, device=dev), torch.zeros(n, dtype=torch.int64, device=dev)
    idle = Ray(torch.zeros((n, 3), device=dev), torch.zeros((n, 3), device=dev), z, z)
    path = path_int.PathLanes.start(idle, smp.make_sampler(zi, zi, seed))
    return PathState(path._replace(active=torch.zeros_like(path.active)), bounce=zi,
                     pos=torch.zeros((n, 2), device=dev),
                     next_work=torch.zeros((), dtype=torch.int64, device=dev))


def _take(spawn, new, old):
    """`new` on the spawning lanes, `old` on the others (tensors or samplers)."""
    if isinstance(new, smp.Sampler):
        return smp.Sampler(rng.Pcg32State(*(torch.where(spawn, a, b)
                                            for a, b in zip(new.state, old.state))))
    return path_int._where(spawn, new, old)


def _refill(state: PathState, scene: SceneData, config: RenderConfig, total_work: int,
            s2c: torch.Tensor | None = None) -> PathState:
    """Give the next work items to the free lanes and spawn their camera
    rays. Work item w is pixel w % n_pix, sample w // n_pix; its sampler
    stream is `render._round_layers`'s: `make_sampler(pixel, sample)`, then
    the 2D jitter and the 2D aperture draws. `s2c` as in
    `camera_ops.sample_ray`."""
    n = state.bounce.shape[0]
    n_pix = config.width * config.height
    free = ~state.path.active
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
    fresh = path_int.PathLanes.start(ray, s)
    return PathState(
        path=path_int.PathLanes(*(_take(spawn, a, b) for a, b in zip(fresh, state.path))),
        bounce=torch.where(spawn, 0, state.bounce), pos=_take(spawn, pos, state.pos),
        next_work=torch.clamp(state.next_work + free.sum(), max=total_work + n))


def _bounce(state: PathState, scene: SceneData, config: RenderConfig) -> PathState:
    """One bounce of every lane, `integrators/path.py: path_bounce` (the
    scan path's body) with the lane's `bounce` in place of the loop index,
    so each path's radiance and AOVs are bit for bit the scan path's; then
    the depth cap: where the scan stops running bounces, the lane ends and
    takes new work."""
    path = path_int.path_bounce(scene, config, state.path, state.bounce,
                                mis=config.integrator == "path_mis")
    path = path._replace(active=path.active & (state.bounce + 1 < config.max_depth))
    return state._replace(path=path, bounce=state.bounce + 1)


def wavefront_iter(acc: torch.Tensor, state: PathState, scene: SceneData, config: RenderConfig,
                   total_work: int, s2c: torch.Tensor | None = None):
    """Refill, one bounce, then splat the paths that ended into `acc`
    [3,H,W,4] in place. Returns (state, n_active), the live lanes' count a
    tensor on the device: nothing here waits for the device."""
    state = _refill(state, scene, config, total_work, s2c)
    was_active = state.path.active
    state = _bounce(state, scene, config)
    p = state.path
    # a dead lane's NaN / Inf must not poison the film, which carries no gradient
    L = torch.nan_to_num(p.L, nan=0.0, posinf=0.0, neginf=0.0)
    film.splat_(acc, config.rfilter, state.pos, torch.stack([L, p.albedo, p.normal]).detach(),
                mask=was_active & ~p.active)
    return state, p.active.sum()


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
