"""Sample warps and their pdfs (reference warp.h:34-99, warp.cpp).

Counterpart of `optix_renderer_tpu/core/warp.py`: `[..., 2]` (or
`[..., 3]`) uniforms in, batched points or directions out, and for every
warp its pdf, zero off the warp's domain. The BSDFs, emitters, camera and
media call the warps; `cli warptest` holds each warp against its pdf by a
χ² test (`utils/hypothesis.py: chi2_sphere_test`).
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core.math import EPSILON, INV_PI, PI, safe_sqrt


def _on_sphere(v: torch.Tensor) -> torch.Tensor:
    return torch.abs((v * v).sum(dim=-1) - 1.0) < EPSILON


def square_to_uniform_square(s: torch.Tensor) -> torch.Tensor:
    return s


def square_to_uniform_square_pdf(p: torch.Tensor) -> torch.Tensor:
    inside = ((p >= 0.0) & (p <= 1.0)).all(dim=-1)
    return torch.where(inside, 1.0, 0.0)


def square_to_uniform_disk(s: torch.Tensor) -> torch.Tensor:
    """Polar mapping (warp.cpp:48-52)."""
    rho = torch.sqrt(s[..., 0])
    theta = s[..., 1] * 2.0 * PI
    return torch.stack([rho * torch.cos(theta), rho * torch.sin(theta)], dim=-1)


def square_to_uniform_disk_pdf(p: torch.Tensor) -> torch.Tensor:
    return torch.where((p * p).sum(dim=-1) <= 1.0, INV_PI, 0.0)


def square_to_uniform_sphere(s: torch.Tensor) -> torch.Tensor:
    """warp.cpp:74-82."""
    z = 2.0 * s[..., 0] - 1.0
    r = safe_sqrt(1.0 - z * z)
    sigma = 2.0 * PI * s[..., 1]
    return torch.stack([r * torch.cos(sigma), r * torch.sin(sigma), z], dim=-1)


def square_to_uniform_sphere_pdf(v: torch.Tensor) -> torch.Tensor:
    return torch.where(_on_sphere(v), 0.25 * INV_PI, 0.0)


def square_to_uniform_sphere_volume(s3: torch.Tensor) -> torch.Tensor:
    """Uniform inside the unit ball from a 3-D sample (warp.cpp:88-92)."""
    r = torch.pow(s3[..., 2], 1.0 / 3.0)
    return r[..., None] * square_to_uniform_sphere(s3[..., :2])


def square_to_uniform_sphere_volume_pdf(p: torch.Tensor) -> torch.Tensor:
    return torch.where((p * p).sum(dim=-1) <= 1.0, 3.0 / (4.0 * PI), 0.0)


def square_to_uniform_sphere_cap(s: torch.Tensor, cos_theta_max: torch.Tensor) -> torch.Tensor:
    """Uniform on the cap z >= cosThetaMax (warp.cpp:58-66)."""
    z = s[..., 0] * (1.0 - cos_theta_max) + cos_theta_max
    r = safe_sqrt(1.0 - z * z)
    theta = s[..., 1] * 2.0 * PI
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], dim=-1)


def square_to_uniform_sphere_cap_pdf(v: torch.Tensor, cos_theta_max) -> torch.Tensor:
    """Constant 1/(2π(1-cosθmax)) on the cap (warp.cpp:68-72)."""
    on_cap = _on_sphere(v) & (v[..., 2] > cos_theta_max)
    return torch.where(on_cap, 1.0 / (2.0 * PI * (1.0 - cos_theta_max)), 0.0)


def square_to_uniform_hemisphere(s: torch.Tensor) -> torch.Tensor:
    """The uniform sphere folded onto z >= 0 (warp.py:81-83 of the JAX package)."""
    v = square_to_uniform_sphere(s)
    return torch.cat([v[..., :2], torch.abs(v[..., 2:3])], dim=-1)


def square_to_uniform_hemisphere_pdf(v: torch.Tensor) -> torch.Tensor:
    return torch.where(_on_sphere(v) & (v[..., 2] > 0), 0.5 * INV_PI, 0.0)


def square_to_cosine_hemisphere(s: torch.Tensor) -> torch.Tensor:
    """Disk projection (Malley's method, warp.cpp:111-122)."""
    d = square_to_uniform_disk(s)
    z = safe_sqrt(1.0 - (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]))
    return torch.cat([d, z[..., None]], dim=-1)


def square_to_cosine_hemisphere_pdf(v: torch.Tensor) -> torch.Tensor:
    return torch.where(_on_sphere(v) & (v[..., 2] > 0), v[..., 2] * INV_PI, 0.0)


def square_to_beckmann(s: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Beckmann NDF sampling (warp.cpp:131-150)."""
    log_sample = torch.log(torch.clamp(1.0 - s[..., 0], min=1e-38))
    tan2_theta = -alpha * alpha * log_sample
    phi = s[..., 1] * 2.0 * PI
    cos_t = 1.0 / torch.sqrt(1.0 + tan2_theta)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def square_to_beckmann_pdf(m: torch.Tensor, alpha) -> torch.Tensor:
    """warp.cpp:152-160."""
    ct = m[..., 2]
    r = torch.sqrt(m[..., 0] * m[..., 0] + m[..., 1] * m[..., 1])
    tan_theta = r / torch.where(torch.abs(ct) > 1e-20, ct, 1e-20)
    on = _on_sphere(m) & (ct > 0)
    pdf = torch.exp(-tan_theta * tan_theta / (alpha * alpha)) / (
        PI * alpha * alpha * torch.clamp(ct * ct * ct, min=1e-20))
    return torch.where(on, pdf, 0.0)


def square_to_uniform_triangle(s: torch.Tensor) -> torch.Tensor:
    """Barycentric coords uniform over the simplex (warp.cpp:162-166)."""
    su1 = torch.sqrt(s[..., 0])
    u = 1.0 - su1
    v = s[..., 1] * su1
    return torch.stack([u, v, 1.0 - u - v], dim=-1)


def _polar(cos_theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    return torch.stack([sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1)


def square_to_henyey_greenstein(s: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Henyey–Greenstein sampling (warp.cpp:168-198); isotropic for |g| < ε."""
    iso = torch.abs(g) < EPSILON
    safe_g = torch.where(iso, 1.0, g)
    factor = (1.0 - g * g) / (1.0 - g + 2.0 * g * s[..., 0])
    cos_aniso = (1.0 + g * g - factor * factor) / (2.0 * safe_g)
    cos_theta = torch.where(iso, 1.0 - 2.0 * s[..., 0], cos_aniso)
    return _polar(cos_theta, 2.0 * PI * s[..., 1])


def square_to_henyey_greenstein_pdf(m: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """warp.cpp:200-205."""
    g2 = g * g
    return 0.25 * INV_PI * (1.0 - g2) / torch.pow(
        torch.clamp(1.0 + g2 - 2.0 * g * m[..., 2], min=1e-12), 1.5)


def square_to_schlick(s: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Schlick phase sampling by the exact inverse CDF of its pdf: the JAX
    package's deliberate deviation from warp.cpp:207-234 (warp.py:162-182)."""
    iso = torch.abs(k) < EPSILON
    safe_k = torch.where(iso, 1.0, k)
    cos_aniso = (1.0 / safe_k) * (1.0 - (1.0 - k * k) / (1.0 - k + 2.0 * k * s[..., 0]))
    cos_theta = torch.where(iso, 1.0 - 2.0 * s[..., 0], cos_aniso)
    return _polar(cos_theta, 2.0 * PI * s[..., 1])


def square_to_schlick_pdf(m: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """warp.cpp:236-241."""
    factor = 1.0 - k * m[..., 2]
    return 0.25 * INV_PI * (1.0 - k * k) / torch.clamp(factor * factor, min=1e-12)
