"""Math substrate of the general path: constants, vector helpers, frames, rays.

The subset of `optix_renderer_tpu/core/math.py` that the wavefront
integrators use, on batched `[..., 3]` float32 tensors. Dot products are
written out component by component, left to right, so that every sum is
associated the same way on the CPU, on the GPU and in the CUDA kernels of
`csrc/isect.cu`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

def rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`table[idx]` for an integer index tensor of any shape, through
    `index_select`: the same values, but a backward that adds with
    `index_add_` where advanced indexing's sorts the indices, which is ~40x
    slower on the card when every lane of a wavefront reads one of a few
    rows (a parameter table: chip_smoke.py phase 20, PERF.md)."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(*idx.shape, *table.shape[1:])


# Reference `include/nori/common.h:56`
EPSILON = 1e-4
PI = 3.14159265358979323846
INV_PI = 1.0 / PI
INV_FOURPI = 0.25 / PI


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the last axis, keeps batch shape."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def squared_norm(a: torch.Tensor) -> torch.Tensor:
    return dot(a, a)


def normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize: a · rsqrt(|a|²), 0 where |a|² <= eps."""
    n2 = squared_norm(a)[..., None]
    return a * torch.where(n2 > eps, 1.0 / torch.sqrt(torch.clamp(n2, min=eps)), 0.0)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def safe_sqrt(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return torch.sqrt(torch.clamp(x, min=eps))


def safe_normalize(a: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """a/‖a‖ that stays finite at a=0 (returns ~0 there)."""
    return a * torch.rsqrt(squared_norm(a)[..., None] + eps)


def luminance(c: torch.Tensor) -> torch.Tensor:
    """Linear-RGB luminance, matches `Color3f::getLuminance` (color.h)."""
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169


# ---------------------------------------------------------------------------
# Shading frame (reference `include/nori/frame.h`)
# ---------------------------------------------------------------------------


class Frame(NamedTuple):
    """Orthonormal shading frame; all fields `[..., 3]` (n = local +z)."""

    s: torch.Tensor
    t: torch.Tensor
    n: torch.Tensor


def coordinate_system(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Tangent / bitangent of a unit normal, branch-free (Duff et al. 2017)."""
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    s = torch.stack([1.0 + sign * nx * nx * a, sign * b, -sign * nx], dim=-1)
    t = torch.stack([b, sign + ny * ny * a, -ny], dim=-1)
    return s, t


def make_frame(n: torch.Tensor) -> Frame:
    s, t = coordinate_system(n)
    return Frame(s=s, t=t, n=n)


def frame_to_local(f: Frame, v: torch.Tensor) -> torch.Tensor:
    """World → local (frame.h:59-62)."""
    return torch.stack([dot(v, f.s), dot(v, f.t), dot(v, f.n)], dim=-1)


def frame_to_world(f: Frame, v: torch.Tensor) -> torch.Tensor:
    """Local → world (frame.h:65-67)."""
    return f.s * v[..., 0:1] + f.t * v[..., 1:2] + f.n * v[..., 2:3]


# ---------------------------------------------------------------------------
# Rays (reference `include/nori/ray.h`)
# ---------------------------------------------------------------------------


class Ray(NamedTuple):
    """Batched ray: origin / direction `[N, 3]`, interval `[N]`."""

    o: torch.Tensor
    d: torch.Tensor
    mint: torch.Tensor
    maxt: torch.Tensor


# ---------------------------------------------------------------------------
# Optics helpers (reference `src/utils/common.cpp` fresnel)
# ---------------------------------------------------------------------------


def fresnel_dielectric(cos_theta_i: torch.Tensor, ext_ior, int_ior) -> torch.Tensor:
    """Unpolarized dielectric Fresnel reflectance; 1 on total internal
    reflection, 0 for matched media (common.h:275)."""
    entering = cos_theta_i > 0.0
    eta_i = torch.where(entering, ext_ior, int_ior)
    eta_t = torch.where(entering, int_ior, ext_ior)
    ci = torch.abs(cos_theta_i)
    eta = eta_i / eta_t
    sin2_t = eta * eta * torch.clamp(1.0 - ci * ci, min=0.0)
    tir = sin2_t > 1.0
    ct = safe_sqrt(1.0 - sin2_t)
    rs = (eta_i * ci - eta_t * ct) / torch.clamp(eta_i * ci + eta_t * ct, min=1e-20)
    rp = (eta_t * ci - eta_i * ct) / torch.clamp(eta_t * ci + eta_i * ct, min=1e-20)
    f = 0.5 * (rs * rs + rp * rp)
    f = torch.where(tir, 1.0, f)
    return torch.where(torch.abs(eta_i - eta_t) < 1e-12, 0.0, f)


def reflect_local(wi: torch.Tensor) -> torch.Tensor:
    """Mirror reflection in the local frame (mirror.cpp:46-51)."""
    return torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)
