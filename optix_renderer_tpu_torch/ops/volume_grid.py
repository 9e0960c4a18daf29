"""Heterogeneous media: voxel-grid lookups, delta tracking, ratio tracking.

Counterpart of `optix_renderer_tpu/ops/volume_grid.py` (the reference's
heterogmedium.cpp with a dense grid in place of the NanoVDB tree). The
extinction is achromatic, μ(x) = max_c(σt_c)·densityScale·ρ(x), with
majorant M = max_c(σt_c)·max(densityScale·maxDensity, 1e-3)
(heterogmedium.cpp:81, 118-129).

`delta_track` and `ratio_track` run on CUDA tensors in the kernel of
`csrc/track.cu` (`ops/cuda/track.py`) and on CPU tensors in their plain
versions, `delta_track_ref` / `ratio_track_ref`: the JAX package's
`lax.while_loop`s in lockstep, every iteration drawing from every lane's
stream, active or not, until no lane is active or `MAX_TRACK_STEPS`
iterations have run (a host sync per iteration). So after a call every
lane's state has moved on by 2·L (delta) or L (ratio) draws, L the loop's
iteration count. `track_design_ref` is the kernel's decomposition in torch
(each lane walked to its end on its own draws, then every state moved on
by jump-ahead), held bit-equal to the lockstep versions by the CPU tests.

Gradients (differential tracking, as in the JAX package): the walk is a
discrete decision and runs on detached inputs, so the kernel never sees a
graph. The whole dependence of its sampling density on c = max_c(σt_c)·
densityScale is p ∝ M^K·e^(−M·Δ), M = c·ρ̂max the majorant, K the lane's
tentative collisions and Δ the span it walked, whose score is ∂c log p =
K/c − ρ̂max·Δ. So `delta_track` returns a unit weight w_score =
exp((c − sg(c))·score), 1 in value, and `ratio_track` multiplies T by the
same factor over its clipped segment; both are built in torch from the K
the kernel and the plain loops return, with c taken live and the bbox
clip recomputed, and carry the gradient to σa, σs and densityScale.
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core import rng
from optix_renderer_tpu_torch.core.math import rows
from optix_renderer_tpu_torch.scene.data import MediumType

MAX_TRACK_STEPS = 2048


def has_volumes(media) -> bool:
    """Does the scene carry any voxel grids? (a shape, no sync)"""
    return media.vol_corners.shape[0] > 0


def density_at(media, med_id, p):
    """Scaled density densityScale·trilinear(ρ, p), 0 outside the grid's bbox
    (NvdbVolume::getDensity, trilinear where the reference is triquadratic,
    as in the JAX package)."""
    mid = torch.clamp(med_id, min=0).long()
    return rows(media.density_scale, mid) * _trilinear_at(media, med_id, p, media.vol_corners)


def temperature_at(media, med_id, p):
    """Trilinear temperature lookup (NvdbVolume::getTemperature analog)."""
    return _trilinear_at(media, med_id, p, media.vol_tcorners)


def _trilinear_at(media, med_id, p, corners):
    """One 8-value row of the corner stack per lane, weighted in (z, y, x)
    order. The stack lives in a one-voxel zero-padded index space, so voxels
    outside the grid read 0; the eight terms are added in sequence, the
    order `csrc/track.cu: density` adds them in."""
    mid = torch.clamp(med_id, min=0).long()
    vid = torch.clamp(media.vol_id[mid], min=0).long()
    bmin, bmax = media.vol_bbox_min[vid], media.vol_bbox_max[vid]
    dims = media.vol_dims[vid].to(torch.float32)  # (D, H, W)
    rel = (p - bmin) / torch.clamp(bmax - bmin, min=1e-20)
    f = rel.flip(-1) * dims - 0.5  # (z, y, x) index coordinates
    f0 = torch.floor(f)
    w = f - f0
    i0 = f0.to(torch.int32)
    D, H, W = media.grid
    bz = torch.clamp(i0[..., 0] + 1, 0, D)
    by = torch.clamp(i0[..., 1] + 1, 0, H)
    bx = torch.clamp(i0[..., 2] + 1, 0, W)
    flat = (bz * (H + 1) + by) * (W + 1) + bx
    c = corners[vid, flat.long()]  # [N, 8]
    wz, wy, wx = w.unbind(-1)
    az, ay, ax = (1.0 - w).unbind(-1)
    d = c[..., 0] * (az * ay * ax)
    d = d + c[..., 1] * (az * ay * wx)
    d = d + c[..., 2] * (az * wy * ax)
    d = d + c[..., 3] * (az * wy * wx)
    d = d + c[..., 4] * (wz * ay * ax)
    d = d + c[..., 5] * (wz * ay * wx)
    d = d + c[..., 6] * (wz * wy * ax)
    d = d + c[..., 7] * (wz * wy * wx)
    inside = ((p >= bmin) & (p <= bmax)).all(dim=-1)
    return torch.where(inside, d, 0.0)


def _bbox_clip(o, d, bmin, bmax, tmin, tmax):
    """Clip [tmin, tmax] to the box; returns (t0, t1), t0 > t1 on a miss."""
    inv = 1.0 / torch.where(torch.abs(d) > 1e-20, d, 1e-20)
    ta = (bmin - o) * inv
    tb = (bmax - o) * inv
    near = torch.minimum(ta, tb).amax(dim=-1)
    far = torch.maximum(ta, tb).amin(dim=-1)
    return torch.maximum(near, tmin), torch.minimum(far, tmax)


def _majorant(media, med_id):
    """M = max_c(σt_c)·max(densityScale·maxDensity, 1e-3), the reference's
    floor (heterogmedium.cpp:81)."""
    mid = torch.clamp(med_id, min=0).long()
    st_max = (rows(media.sigma_a, mid) + rows(media.sigma_s, mid)).amax(dim=-1)
    vid = torch.clamp(media.vol_id[mid], min=0).long()
    return st_max * torch.clamp(rows(media.density_scale, mid) * media.vol_majorant[vid], min=1e-3)


def _setup(media, med_id, o, d, t_max):
    """(t, t1, M, σt_max, active) at the start of a walk: heterogeneous
    lanes whose ray meets the grid's bbox inside [0, t_max]."""
    mid = torch.clamp(med_id, min=0).long()
    is_het = (med_id >= 0) & (media.type[mid] == MediumType.HETEROG)
    vid = torch.clamp(media.vol_id[mid], min=0).long()
    t0, t1 = _bbox_clip(o, d, media.vol_bbox_min[vid], media.vol_bbox_max[vid],
                        torch.zeros_like(t_max), t_max)
    M = _majorant(media, med_id)
    st_max = (rows(media.sigma_a, mid) + rows(media.sigma_s, mid)).amax(dim=-1)
    return t0, t1, M, st_max, is_het & (t0 <= t1) & (M > 1e-12)


def _step(media, med_id, st, t, o, d, t1, M, st_max, ratio: bool):
    """One tentative collision of every lane → (state, t_new, escaped, μ/M
    at t_new, u2); u2 is None in ratio tracking (one draw per step)."""
    st, u1 = rng.pcg32_next_float(st)
    u2 = None
    if not ratio:
        st, u2 = rng.pcg32_next_float(st)
    t_new = t - torch.log(torch.clamp(1.0 - u1, min=1e-38)) / torch.clamp(M, min=1e-20)
    escaped = t_new > t1
    rho = density_at(media, med_id, o + d * t_new[..., None])
    return st, t_new, escaped, rho * st_max / torch.clamp(M, min=1e-20), u2


def _walk(media, med_id, state, o, d, t_max, ratio: bool, lockstep: bool):
    """The tracking loop → (out, K, state, L). Lockstep: every lane draws in
    every iteration (the JAX loop). Otherwise only the lanes still active
    draw, as when each lane walks alone (the kernel's first launch)."""
    t, t1, M, st_max, active = _setup(media, med_id, o, d, t_max)
    n = o.shape[0]
    out = torch.full((n,), 1.0 if ratio else float("inf"), device=o.device)
    k = torch.zeros(n, dtype=torch.int32, device=o.device)
    steps = 0
    while steps < MAX_TRACK_STEPS and bool(active.any()):
        st, t_new, escaped, ratio_mu, u2 = _step(media, med_id, state, t, o, d, t1, M, st_max,
                                                 ratio)
        state = st if lockstep else rng.Pcg32State(
            *(torch.where(active, a, b) for a, b in zip(st, state)))
        inside = active & ~escaped
        k = torch.where(inside, k + 1, k)
        if ratio:
            out = torch.where(inside, out * torch.clamp(1.0 - ratio_mu, min=0.0), out)
            active = inside & (out > 1e-6)
        else:
            real = ratio_mu >= u2
            out = torch.where(inside & real, t_new, out)
            active = inside & ~real
        t = torch.where(active, t_new, t)
        steps += 1
    return out, k, state, steps


def delta_track_ref(media, med_id, s, ro, rd, t_max):
    """Plain delta tracking (the lockstep loop) → (sampler, t_event [N], K
    [N] int32); t_event = +inf where the walk escapes t_max or the bbox."""
    t_event, k, state, _ = _walk(media, med_id, s.state, ro, rd, t_max, False, True)
    return s._replace(state=state), t_event, k


def ratio_track_ref(media, med_id, s, o, d, dist):
    """Plain ratio tracking over [0, dist] (the lockstep loop) → (sampler,
    T [N], K [N] int32); T = 1 on lanes that are not heterogeneous."""
    tr, k, state, _ = _walk(media, med_id, s.state, o, d, dist, True, True)
    return s._replace(state=state), tr, k


def track_design_ref(media, med_id, s, o, d, t_max, ratio: bool):
    """The kernel's decomposition in torch: every lane walked to its end on
    its own draws, then every state moved on by 2·L (or L) draws by
    `rng.pcg32_advance` → (sampler, out, K, L)."""
    out, k, _, steps = _walk(media, med_id, s.state, o, d, t_max, ratio, False)
    state = rng.pcg32_advance(s.state, (1 if ratio else 2) * steps)
    return s._replace(state=state), out, k, steps


def _score_factor(media, med_id, M, active, k, span):
    """exp((c − sg(c))·score) with c = max_c(σt_c)·densityScale taken live
    and score = K/sg(c) − ρ̂max·span on the lanes that entered the grid, 0
    elsewhere (volume_grid.py:190-198, 238-247 of the JAX package): exactly
    1 in value; its derivative is the free-flight pdf's score."""
    mid = torch.clamp(med_id, min=0).long()
    st_max = (rows(media.sigma_a, mid) + rows(media.sigma_s, mid)).amax(dim=-1)
    scale = rows(media.density_scale, mid)
    c = st_max * scale
    c_det = c.detach()
    rho_max = M / torch.clamp(st_max.detach() * scale.detach(), min=1e-20)
    score = k.to(torch.float32) / torch.clamp(c_det, min=1e-20) - rho_max * span
    score = torch.where(active, score, 0.0)
    return torch.exp((c - c_det) * score)


def delta_track(media, med_id, s, ro, rd, t_max):
    """Woodcock (delta) tracking to the next real collision → (sampler,
    t_event [N], w_score [N]): the walk in the kernel on CUDA tensors, in
    `delta_track_ref` on CPU tensors, on detached inputs; w_score is 1 in
    value and carries the score of the free-flight pdf (the span runs to the
    event, or to the bbox exit on an escape)."""
    live = media
    media, ro, rd, t_max = media.detach(), ro.detach(), rd.detach(), t_max.detach()
    if ro.device.type == "cpu":
        s, t_event, k = delta_track_ref(media, med_id, s, ro, rd, t_max)
    else:
        from optix_renderer_tpu_torch.ops.cuda import track

        t_event, k, state, _ = track.track(False, media, med_id, s.state, ro, rd, t_max)
        s = s._replace(state=state)
    t0, t1, M, _, active = _setup(media, med_id, ro, rd, t_max)
    span = torch.where(torch.isfinite(t_event), t_event, t1) - t0
    return s, t_event, _score_factor(live, med_id, M, active, k, span)


def ratio_track(media, med_id, s, o, d, dist):
    """Ratio-tracking transmittance over [0, dist] → (sampler, T [N,3]),
    T = Π(1 − μ(x_k)/M) over majorant-sampled points, achromatic and 1 on
    lanes that are not heterogeneous: the walk in the kernel on CUDA
    tensors, in `ratio_track_ref` on CPU tensors, on detached inputs; T is
    multiplied by the score factor over the clipped segment t1 − t0, which
    leaves its value as it is."""
    live = media
    media, o, d, dist = media.detach(), o.detach(), d.detach(), dist.detach()
    if o.device.type == "cpu":
        s, tr, k = ratio_track_ref(media, med_id, s, o, d, dist)
    else:
        from optix_renderer_tpu_torch.ops.cuda import track

        tr, k, state, _ = track.track(True, media, med_id, s.state, o, d, dist)
        s = s._replace(state=state)
    t0, t1, M, _, active = _setup(media, med_id, o, d, dist)
    tr = tr * _score_factor(live, med_id, M, active, k, torch.clamp(t1 - t0, min=0.0))
    return s, tr[..., None].expand(-1, 3)
