"""BSDFs of the general path: sample / eval / pdf over the material table.

Counterpart of `optix_renderer_tpu/ops/bsdf.py` (reference diffuse.cpp,
mirror.cpp, dielectric.cpp:52-102, microfacet.cpp:20-160, disney.cpp). All
directions are in the local shading frame (+z = normal); every type's
arithmetic runs for every lane and per-lane material ids select the result.
Smooth lobes are ESolidAngle; mirror and dielectric are EDiscrete (eval and
pdf ≡ 0, sample returns the full weight), which path MIS relies on.

This module is the general path's own: the path kernel's BSDF functions
(`ops/cuda/mega.py`) follow the JAX kernel, whose rounding differs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from optix_renderer_tpu_torch.core import warp
from optix_renderer_tpu_torch.core.math import (
    INV_PI,
    PI,
    dot,
    fresnel_dielectric,
    reflect_local,
    rows,
    safe_normalize,
    safe_sqrt,
)
from optix_renderer_tpu_torch.ops import disney
from optix_renderer_tpu_torch.ops.texture import eval_texture
from optix_renderer_tpu_torch.scene.data import Bsdfs, BsdfType, Textures


class BsdfSample(NamedTuple):
    wo: torch.Tensor  # [N,3] sampled outgoing direction (local frame)
    weight: torch.Tensor  # [N,3] f/pdf·cos (or the discrete weight)
    pdf: torch.Tensor  # [N] solid-angle pdf (0 for discrete)
    is_discrete: torch.Tensor  # [N] bool (EDiscrete measure)
    eta: torch.Tensor  # [N] relative IOR of the sampled event


def _cos(v):
    return v[..., 2]


def _sel(mask, a, b):
    """where(mask, a, b) with a per-lane mask broadcast over a trailing axis."""
    return torch.where(mask[..., None] if a.dim() > mask.dim() else mask, a, b)


def _beckmann_d(m, alpha):
    """Beckmann NDF (microfacet.cpp:60-67) as exp(·)·(1/ct²)² / (πα²)."""
    ct = torch.clamp(_cos(m), min=1e-4)
    inv_ct2 = 1.0 / (ct * ct)
    tan2 = torch.clamp(1.0 - ct * ct, min=0.0) * inv_ct2
    return torch.exp(-tan2 / (alpha * alpha)) * inv_ct2 * inv_ct2 / (PI * alpha * alpha)


def _smith_g1(v, m, alpha):
    """Smith shadowing-masking G1, rational approximation (microfacet.cpp:70-90)."""
    ct = _cos(v)
    tan_theta = safe_sqrt(1.0 - ct * ct) / torch.where(torch.abs(ct) > 1e-8, ct, 1e-8)
    a = 1.0 / torch.clamp(alpha * torch.abs(tan_theta), min=1e-8)
    a2 = a * a
    approx = (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2)
    g = torch.where(a >= 1.6, 1.0, approx)
    g = torch.where(torch.abs(tan_theta) < 1e-8, 1.0, g)
    back = dot(m, v) * ct <= 0.0
    return torch.where(back, 0.0, g)


def _microfacet_eval(kd, ks, alpha, ext_ior, int_ior, wi, wo):
    """kd/π + ks·D·F·G1G1 / (4 cosθi cosθo) (microfacet.cpp:93-106)."""
    wh = safe_normalize(wi + wo)
    d = _beckmann_d(wh, alpha)
    f = fresnel_dielectric(dot(wh, wi), ext_ior, int_ior)
    g = _smith_g1(wi, wh, alpha) * _smith_g1(wo, wh, alpha)
    denom = 4.0 * _cos(wi) * _cos(wo)
    spec = ks * d * f * g / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
    val = kd * INV_PI + spec[..., None]
    return torch.where((_cos(wo) > 0.0)[..., None], val, 0.0)


def _microfacet_pdf(ks, alpha, wi, wo):
    """ks·D(wh)·cosθh/(4 wo·wh) + (1-ks)·cosθo/π (microfacet.cpp:109-120)."""
    wh = safe_normalize(wi + wo)
    d = _beckmann_d(wh, alpha)
    dot_wo_wh = dot(wo, wh)
    q = 4.0 * dot_wo_wh
    part1 = ks * d * _cos(wh) / torch.where(torch.abs(q) > 1e-12, q, 1e-12)
    part2 = (1.0 - ks) * _cos(wo) * INV_PI
    return torch.where(_cos(wo) > 0.0, part1 + part2, 0.0)


def _lookup(bsdfs: Bsdfs, bsdf_id):
    bid = torch.clamp(bsdf_id, min=0).long()
    return bid, bsdfs.type[bid]


def eval_bsdf(bsdfs: Bsdfs, textures: Textures, bsdf_id, wi, wo, uv) -> torch.Tensor:
    """f(wi, wo) under the solid-angle measure; discrete types → 0."""
    bid, btype = _lookup(bsdfs, bsdf_id)
    albedo = eval_texture(textures, bsdfs.albedo_tex[bid], uv)
    diff_ok = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    f_diffuse = torch.where(diff_ok[..., None], albedo * INV_PI, 0.0)
    f_micro = _microfacet_eval(rows(bsdfs.kd, bid), bsdfs.ks[bid], rows(bsdfs.alpha, bid),
                               bsdfs.ext_ior[bid], bsdfs.int_ior[bid], wi, wo)
    f_disney = disney.disney_eval(bsdfs.disney[bid], albedo, wi, wo)
    return _sel(btype == BsdfType.DIFFUSE, f_diffuse,
                _sel(btype == BsdfType.MICROFACET, f_micro,
                     _sel(btype == BsdfType.DISNEY, f_disney, torch.zeros_like(f_micro))))


def pdf_bsdf(bsdfs: Bsdfs, textures: Textures, bsdf_id, wi, wo, uv) -> torch.Tensor:
    del textures, uv  # no pdf depends on a texture
    bid, btype = _lookup(bsdfs, bsdf_id)
    diff_ok = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    p_diffuse = torch.where(diff_ok, INV_PI * _cos(wo), 0.0)
    p_micro = _microfacet_pdf(bsdfs.ks[bid], rows(bsdfs.alpha, bid), wi, wo)
    p_disney = disney.disney_pdf(bsdfs.disney[bid], wi, wo)
    return torch.where(btype == BsdfType.DIFFUSE, p_diffuse,
                       torch.where(btype == BsdfType.MICROFACET, p_micro,
                                   torch.where(btype == BsdfType.DISNEY, p_disney, 0.0)))


def sample_bsdf(bsdfs: Bsdfs, textures: Textures, bsdf_id, wi, uv, u2) -> BsdfSample:
    """Importance-sample the BSDF; u2 `[N,2]` uniforms.

    Weights are the reference `sample()` returns: diffuse → albedo,
    mirror → 1, dielectric → 1 or 1/η², microfacet → eval/pdf·cos,
    disney → f·π.
    """
    bid, btype = _lookup(bsdfs, bsdf_id)
    albedo = eval_texture(textures, bsdfs.albedo_tex[bid], uv)
    cos_i = _cos(wi)
    ones = torch.ones_like(wi)

    # diffuse
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    w_diff = torch.where((cos_i > 0.0)[..., None], albedo, 0.0)

    # mirror
    wo_mirror = reflect_local(wi)
    w_mirror = torch.where((cos_i > 0.0)[..., None], ones, 0.0)

    # dielectric (dielectric.cpp:52-102): local-frame Snell, normal = ±z
    int_ior = bsdfs.int_ior[bid]
    ext_ior = bsdfs.ext_ior[bid]
    fr = fresnel_dielectric(cos_i, ext_ior, int_ior)
    reflect_event = u2[..., 0] < fr
    entering = cos_i >= 0.0
    eta_ratio = torch.where(entering, ext_ior / int_ior, int_ior / ext_ior)
    nz = torch.where(entering, 1.0, -1.0)
    wi_dot_n = wi[..., 2] * nz
    sqrt_term = safe_sqrt(1.0 - eta_ratio * eta_ratio * (1.0 - wi_dot_n * wi_dot_n))
    zero = torch.zeros_like(nz)
    tang = wi - torch.stack([zero, zero, wi_dot_n * nz], dim=-1)
    wo_refr = (-eta_ratio[..., None] * tang
               - (sqrt_term * nz)[..., None] * torch.stack([zero, zero, torch.ones_like(nz)],
                                                           dim=-1))
    wo_diel = torch.where(reflect_event[..., None], reflect_local(wi), wo_refr)
    w_refr = (1.0 / (eta_ratio * eta_ratio))[..., None] * ones
    w_diel = torch.where(reflect_event[..., None], ones, w_refr)
    eta_diel = torch.where(reflect_event, 1.0, eta_ratio)

    # microfacet (microfacet.cpp:123-160)
    ks = bsdfs.ks[bid]
    alpha = rows(bsdfs.alpha, bid)
    spec_event = u2[..., 1] < ks
    u_spec = torch.stack([u2[..., 0], u2[..., 1] / torch.clamp(ks, min=1e-8)], dim=-1)
    u_diff = torch.stack([u2[..., 0], (u2[..., 1] - ks) / torch.clamp(1.0 - ks, min=1e-8)],
                         dim=-1)
    wh = warp.square_to_beckmann(u_spec, alpha)
    wo_spec = 2.0 * dot(wi, wh)[..., None] * wh - wi
    wo_mf = torch.where(spec_event[..., None], wo_spec,
                        warp.square_to_cosine_hemisphere(u_diff))
    f_mf = _microfacet_eval(rows(bsdfs.kd, bid), ks, alpha, ext_ior, int_ior, wi, wo_mf)
    p_mf = _microfacet_pdf(ks, alpha, wi, wo_mf)
    w_mf = f_mf * (_cos(wo_mf) / torch.clamp(p_mf, min=1e-12))[..., None]
    w_mf = torch.where(((_cos(wo_mf) > 0.0) & (cos_i >= 0.0) & (p_mf > 1e-12))[..., None],
                       w_mf, 0.0)

    # disney
    wo_dis, w_dis, p_dis = disney.disney_sample(bsdfs.disney[bid], albedo, wi, u2)

    is_mirror = btype == BsdfType.MIRROR
    is_diel = btype == BsdfType.DIELECTRIC
    is_micro = btype == BsdfType.MICROFACET
    is_disney = btype == BsdfType.DISNEY

    def pick(mirror, diel, micro, dis, diff):
        return _sel(is_mirror, mirror, _sel(is_diel, diel, _sel(is_micro, micro,
                                                                 _sel(is_disney, dis, diff))))

    wo = pick(wo_mirror, wo_diel, wo_mf, wo_dis, wo_diff)
    weight = pick(w_mirror, w_diel, w_mf, w_dis, w_diff)
    is_discrete = is_mirror | is_diel
    eta = torch.where(is_diel, eta_diel, 1.0)
    pdf_cont = torch.where(
        is_micro, p_mf,
        torch.where(is_disney, p_dis,
                    torch.where((btype == BsdfType.DIFFUSE) & (cos_i > 0.0),
                                INV_PI * torch.clamp(_cos(wo), min=0.0), 0.0)))
    pdf = torch.where(is_discrete, 0.0, pdf_cont)
    return BsdfSample(wo=wo, weight=weight, pdf=pdf, is_discrete=is_discrete, eta=eta)
