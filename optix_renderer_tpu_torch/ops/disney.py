"""Disney principled BRDF (batched, local frame).

Counterpart of `optix_renderer_tpu/ops/disney.py` (reference disney.cpp:
111-332): Burley diffuse + subsurface approximation, GTR2 anisotropic
specular, sheen, GTR1 clearcoat; cosine-hemisphere sampling with pdf
cosθo/π and the reference's luminance clamp on eval.

params [N,10]: (metallic, subsurface, specular, roughness, specularTint,
anisotropic, sheen, sheenTint, clearcoat, clearcoatGloss) — disney.cpp:32-41.
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core import warp
from optix_renderer_tpu_torch.core.math import EPSILON, INV_PI, PI, dot, luminance, safe_normalize


def _mix(a, b, t):
    return a + (b - a) * t


def _schlick_fresnel(a):
    m = torch.clamp(1.0 - a, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def _smith_g_ggx_aniso(ndotv, vdotx, vdoty, ax, ay):
    return 1.0 / torch.clamp(
        ndotv + torch.sqrt(vdotx * ax * vdotx * ax + vdoty * ay * vdoty * ay + ndotv * ndotv),
        min=1e-8)


def _smith_g_ggx(ndotv, alpha_g):
    a = alpha_g * alpha_g
    b = ndotv * ndotv
    return 1.0 / torch.clamp(ndotv + torch.sqrt(a + b - a * b), min=1e-8)


def _gtr1(ndoth, a):
    a = torch.clamp(a, min=1e-4)
    a2 = a * a
    t = 1.0 + (a2 - 1.0) * ndoth * ndoth
    val = (a2 - 1.0) / (PI * torch.log(a2) * t)
    return torch.where(a >= 1.0, INV_PI, val)


def _gtr2_aniso(ndoth, hdotx, hdoty, ax, ay):
    s = (hdotx / ax) ** 2 + (hdoty / ay) ** 2 + ndoth * ndoth
    return 1.0 / torch.clamp(PI * ax * ay * s ** 2, min=1e-12)


def disney_eval(params: torch.Tensor, base_color: torch.Tensor, wi, wo) -> torch.Tensor:
    """f(wi, wo) [N,3]; wi = L, wo = V in the reference's convention (disney.cpp:115)."""
    (metallic, subsurface, specular, roughness, specular_tint, anisotropic, sheen,
     sheen_tint, clearcoat, clearcoat_gloss) = params.unbind(-1)
    L, V = wi, wo
    ndotl = L[..., 2]
    ndotv = V[..., 2]
    valid = (ndotl >= EPSILON) & (ndotv >= EPSILON)

    H = safe_normalize(L + V)
    ndoth = H[..., 2]
    ldoth = dot(L, H)

    # mon2lin: pow(c, 2.2) (disney.cpp:291-296)
    cdlin = torch.pow(torch.clamp(base_color, min=1e-6), 2.2)
    cdlum = 0.3 * cdlin[..., 0] + 0.6 * cdlin[..., 1] + 0.1 * cdlin[..., 2]
    ctint = torch.where((cdlum > 0.0)[..., None],
                        cdlin / torch.clamp(cdlum, min=1e-12)[..., None], 1.0)
    ones = torch.ones_like(ctint)
    cspec0 = _mix(specular[..., None] * 0.08 * _mix(ones, ctint, specular_tint[..., None]),
                  cdlin, metallic[..., None])
    csheen = _mix(ones, ctint, sheen_tint[..., None])

    fl = _schlick_fresnel(ndotl)
    fv = _schlick_fresnel(ndotv)
    fd90 = 0.5 + 2.0 * ldoth * ldoth * roughness
    fd = _mix(1.0, fd90, fl) * _mix(1.0, fd90, fv)

    fss90 = ldoth * ldoth * roughness
    fss = _mix(1.0, fss90, fl) * _mix(1.0, fss90, fv)
    ss = 1.25 * (fss * (1.0 / torch.clamp(ndotl + ndotv, min=1e-8) - 0.5) + 0.5)

    aspect = torch.sqrt(1.0 - anisotropic * 0.9)
    ax = torch.clamp(roughness * roughness / aspect, min=0.001)
    ay = torch.clamp(roughness * roughness * aspect, min=0.001)
    ds = _gtr2_aniso(ndoth, H[..., 0], H[..., 1], ax, ay)
    fh = _schlick_fresnel(ldoth)
    fs = _mix(cspec0, torch.ones_like(cspec0), fh[..., None])
    gs = _smith_g_ggx_aniso(ndotl, L[..., 0], L[..., 1], ax, ay)
    gs = gs * _smith_g_ggx_aniso(ndotv, V[..., 0], V[..., 1], ax, ay)

    fsheen = fh[..., None] * sheen[..., None] * csheen

    dr = _gtr1(ndoth, _mix(0.1, 0.001, clearcoat_gloss))
    fr = _mix(0.04, 1.0, fh)
    gr = _smith_g_ggx(ndotl, 0.25) * _smith_g_ggx(ndotv, 0.25)

    final = ((INV_PI * _mix(fd, ss, subsurface)[..., None] * cdlin + fsheen)
             * (1.0 - metallic)[..., None]
             + (gs * ds)[..., None] * fs
             + (0.25 * clearcoat * gr * fr * dr)[..., None])
    # the reference clamps by luminance (disney.cpp:174-176)
    lum = luminance(final)
    final = torch.where((lum > 1.0)[..., None], final / torch.clamp(lum, min=1e-12)[..., None],
                        final)
    return torch.where(valid[..., None], final, 0.0)


def disney_pdf(params: torch.Tensor, wi, wo) -> torch.Tensor:
    """Cosine-hemisphere pdf (disney.cpp:201-208)."""
    del params
    ok = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    return torch.where(ok, INV_PI * wo[..., 2], 0.0)


def disney_sample(params: torch.Tensor, base_color: torch.Tensor, wi, u2):
    """Cosine sampling (disney.cpp:181-199) with the estimator weight f·π
    (the JAX package's correction of the reference's bare eval())."""
    wo = warp.square_to_cosine_hemisphere(u2)
    f = disney_eval(params, base_color, wi, wo)
    pdf = disney_pdf(params, wi, wo)
    weight = torch.where(((wi[..., 2] > 0.0) & (pdf >= EPSILON))[..., None], f * PI, 0.0)
    return wo, weight, pdf
