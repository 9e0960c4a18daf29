"""Participating media: free-path sampling, transmittance, phase functions.

Counterpart of `optix_renderer_tpu/ops/medium.py` (the reference's
vacuum / homogmedium / heterogmedium media and isophase / anisophase /
schlickphase phase functions), with its unbiased spectral estimator: a
distance is sampled from a uniformly chosen channel's exponential; a
medium event is weighted σs·Tr/pdf_t with pdf_t = mean_c μt_c·e^(−μt_c·t),
a surface event Tr/P_surf with P_surf = mean_c e^(−μt_c·t_s).
Heterogeneous lanes use the trackers of `ops/volume_grid.py`.
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core import warp
from optix_renderer_tpu_torch.core.math import INV_FOURPI, rows
from optix_renderer_tpu_torch.ops import volume_grid as vg
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.scene.data import MediumType, PhaseType


def _mid(med_id):
    return torch.clamp(med_id, min=0).long()


def _is_het(media, med_id):
    return (med_id >= 0) & (media.type[_mid(med_id)] == MediumType.HETEROG)


def mu_t(media, med_id):
    """Extinction μt = σa + σs per lane [N,3]; 0 for vacuum and id < 0."""
    mid = _mid(med_id)
    real = (med_id >= 0) & (media.type[mid] != MediumType.VACUUM)
    return torch.where(real[..., None], rows(media.sigma_a, mid) + rows(media.sigma_s, mid), 0.0)


def sample_free_path(media, med_id, u_channel, u_dist):
    """Distance to the next tentative event (∞ in vacuum), channel-uniform
    exponential sampling (homogmedium.cpp:61-67)."""
    mt = mu_t(media, med_id)
    c = torch.clamp((3.0 * u_channel).to(torch.int64), 0, 2)
    mt_c = torch.gather(mt, -1, c[..., None])[..., 0]
    t = -torch.log(torch.clamp(1.0 - u_dist, min=1e-38)) / torch.clamp(mt_c, min=1e-20)
    return torch.where(mt_c < 1e-12, float("inf"), t)


def transmittance(media, med_id, dist):
    """exp(−μt·d) [N,3] (homogmedium.cpp:69-73); 1 in vacuum."""
    return torch.exp(-mu_t(media, med_id) * torch.clamp(dist, max=1e30)[..., None])


def _event_weights(mt, t_medium):
    """(Tr at the medium event [N,3], pdf_t [N])."""
    tm = torch.where(torch.isfinite(t_medium), t_medium, 0.0)
    tr_m = torch.exp(-mt * tm[..., None])
    return tr_m, (mt * tr_m).mean(dim=-1)


def free_path_weights(media, med_id, t_medium, t_surface):
    """(is_medium_event, w_medium [N,3], w_surface [N,3]) of a free-path
    sample: w_medium = σs·e^(−μt·t)/mean_c(μt_c·e^(−μt_c·t)), w_surface =
    e^(−μt·t_s)/mean_c(e^(−μt_c·t_s)); vacuum lanes: a surface event of
    weight 1."""
    mid = _mid(med_id)
    mt = mu_t(media, med_id)
    sigma_s = torch.where((med_id >= 0)[..., None], rows(media.sigma_s, mid), 0.0)
    tr_m, pdf_m = _event_weights(mt, t_medium)
    w_medium = sigma_s * tr_m / torch.clamp(pdf_m, min=1e-20)[..., None]
    tr_s = torch.exp(-mt * torch.clamp(t_surface, max=1e30)[..., None])
    w_surface = tr_s / torch.clamp(tr_s.mean(dim=-1), min=1e-20)[..., None]
    vacuum = (mt < 1e-12).all(dim=-1)
    return ((t_medium < t_surface) & ~vacuum, w_medium,
            torch.where(vacuum[..., None], 1.0, w_surface))


def phase_sample(media, med_id, u2):
    """A direction from the phase function, in the frame of the incident
    ray (z = propagation direction)."""
    mid = _mid(med_id)
    ptype, g = media.phase_type[mid], media.phase_g[mid]
    return torch.where((ptype == PhaseType.ISO)[..., None], warp.square_to_uniform_sphere(u2),
                       torch.where((ptype == PhaseType.HG)[..., None],
                                   warp.square_to_henyey_greenstein(u2, g),
                                   warp.square_to_schlick(u2, g)))


def phase_pdf(media, med_id, wo_local):
    mid = _mid(med_id)
    ptype, g = media.phase_type[mid], media.phase_g[mid]
    return torch.where(ptype == PhaseType.ISO, INV_FOURPI,
                       torch.where(ptype == PhaseType.HG,
                                   warp.square_to_henyey_greenstein_pdf(wo_local, g),
                                   warp.square_to_schlick_pdf(wo_local, g)))


def sample_interaction(media, med_id, s, ro, rd, t_surface):
    """Free-path sample in each lane's medium → (sampler, is_medium [N],
    t_event [N], w_medium, w_surface, w_emission [N,3]). Homogeneous lanes
    use the analytic estimator; with voxel grids in the scene, delta
    tracking runs over the whole wavefront and heterogeneous lanes take its
    event, with w_medium = σs/max_c σt, w_surface = 1 and the emission
    weight 1/(ρ(x)·max_c σt) (the null-collision factors cancel), each
    times the tracker's unit score weight.
    w_emission is the event weight of an emissive field, Tr/pdf_t."""
    s, u_ch = smp.next_1d(s)
    s, u_d = smp.next_1d(s)
    t_med_h = sample_free_path(media, med_id, u_ch, u_d)
    is_med_h, w_m_h, w_s_h = free_path_weights(media, med_id, t_med_h, t_surface)
    tr_m, pdf_m = _event_weights(mu_t(media, med_id), t_med_h)
    w_e_h = tr_m / torch.clamp(pdf_m, min=1e-20)[..., None]
    if not vg.has_volumes(media):
        return s, is_med_h, t_med_h, w_m_h, w_s_h, w_e_h

    mid = _mid(med_id)
    is_het = _is_het(media, med_id)
    s, t_het, w_score = vg.delta_track(media, med_id, s, ro, rd, t_surface)
    st_max = (rows(media.sigma_a, mid) + rows(media.sigma_s, mid)).amax(dim=-1)
    w_m_het = rows(media.sigma_s, mid) / torch.clamp(st_max, min=1e-20)[..., None]
    t_het_f = torch.where(torch.isfinite(t_het), t_het, 0.0)
    rho = vg.density_at(media, med_id, ro + rd * t_het_f[..., None])
    w_e_het = (1.0 / torch.clamp(rho * st_max, min=1e-12))[..., None].expand(-1, 3)
    # differential delta tracking: the unit score weight scales every
    # outcome of the heterogeneous free-flight decision (medium.py:173-178
    # of the JAX package)
    w_score = w_score[..., None]
    h = is_het[..., None]
    return (s, torch.where(is_het, t_het < t_surface, is_med_h),
            torch.where(is_het, t_het, t_med_h), torch.where(h, w_m_het * w_score, w_m_h),
            torch.where(h, w_score.expand(-1, 3), w_s_h), torch.where(h, w_e_het * w_score, w_e_h))


def color_from_temperature(v, scale):
    """Blackbody-style ramp (heterogmedium.cpp:37-44): r = v, g = v², b = v⁴
    → scale·(r³, g³, b³)."""
    g = v * v
    b = g * g
    return scale[..., None] * torch.stack([v ** 3, g ** 3, b ** 3], dim=-1)


def event_emission(media, med_id, p):
    """Temperature-driven emission ε(x) [N,3] of heterogeneous media at a
    medium event, σa·ρ(x)·colorFromTemperature(T(x), temperatureScale);
    0 elsewhere and in scenes without voxel grids. (A volume emitter's
    constant radiance is added by the integrator.)"""
    if not vg.has_volumes(media):
        return torch.zeros_like(p)
    mid = _mid(med_id)
    scale = media.temperature_scale[mid]
    on = _is_het(media, med_id) & (scale > 0.0)
    eps = (rows(media.sigma_a, mid) * vg.density_at(media, med_id, p)[..., None]
           * color_from_temperature(vg.temperature_at(media, med_id, p), scale))
    return torch.where(on[..., None], eps, 0.0)


def transmittance_est(media, med_id, s, o, d, dist):
    """Transmittance of a segment → (sampler, Tr [N,3]): analytic on
    homogeneous lanes; with voxel grids in the scene, ratio tracking over
    the whole wavefront for the heterogeneous ones."""
    tr = transmittance(media, med_id, dist)
    if not vg.has_volumes(media):
        return s, tr
    s, tr_het = vg.ratio_track(media, med_id, s, o, d, dist)
    return s, torch.where(_is_het(media, med_id)[..., None], tr_het, tr)
