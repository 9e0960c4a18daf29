"""Sample warps used by the BSDFs and emitters of the general path.

The subset of `optix_renderer_tpu/core/warp.py` (reference warp.cpp) that
`ops/bsdf.py`, `ops/emitter.py` and `ops/camera.py` call; `[..., 2]`
uniforms in, batched points or directions out.
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core.math import PI, safe_sqrt


def square_to_uniform_disk(s: torch.Tensor) -> torch.Tensor:
    """Polar mapping (warp.cpp:48-52)."""
    rho = torch.sqrt(s[..., 0])
    theta = s[..., 1] * 2.0 * PI
    return torch.stack([rho * torch.cos(theta), rho * torch.sin(theta)], dim=-1)


def square_to_uniform_sphere(s: torch.Tensor) -> torch.Tensor:
    """warp.cpp:74-82."""
    z = 2.0 * s[..., 0] - 1.0
    r = safe_sqrt(1.0 - z * z)
    sigma = 2.0 * PI * s[..., 1]
    return torch.stack([r * torch.cos(sigma), r * torch.sin(sigma), z], dim=-1)


def square_to_uniform_sphere_cap(s: torch.Tensor, cos_theta_max: torch.Tensor) -> torch.Tensor:
    """Uniform on the cap z >= cosThetaMax (warp.cpp:58-66)."""
    z = s[..., 0] * (1.0 - cos_theta_max) + cos_theta_max
    r = safe_sqrt(1.0 - z * z)
    theta = s[..., 1] * 2.0 * PI
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), z], dim=-1)


def square_to_cosine_hemisphere(s: torch.Tensor) -> torch.Tensor:
    """Disk projection (Malley's method, warp.cpp:111-122)."""
    d = square_to_uniform_disk(s)
    z = safe_sqrt(1.0 - (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]))
    return torch.cat([d, z[..., None]], dim=-1)


def square_to_beckmann(s: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Beckmann NDF sampling (warp.cpp:131-150)."""
    log_sample = torch.log(torch.clamp(1.0 - s[..., 0], min=1e-38))
    tan2_theta = -alpha * alpha * log_sample
    phi = s[..., 1] * 2.0 * PI
    cos_t = 1.0 / torch.sqrt(1.0 + tan2_theta)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def square_to_uniform_triangle(s: torch.Tensor) -> torch.Tensor:
    """Barycentric coords uniform over the simplex (warp.cpp:162-166)."""
    su1 = torch.sqrt(s[..., 0])
    u = 1.0 - su1
    v = s[..., 1] * su1
    return torch.stack([u, v, 1.0 - u - v], dim=-1)
