"""Environment map: luminance-importance sampling, eval and pdf over its lat-long tables.

Counterpart of `optix_renderer_tpu/ops/envmap.py` (the reference EnvMap
emitter, environmentmap.cpp:73-168), with its deliberate deviations: the
natural lat-long grid (rows θ ∈ [0, π] from +z, columns φ ∈ [0, 2π)), a
pixel distribution weighted by luminance·sinθ whose pdf is the exact
solid-angle one, pmf / ω_pixel with ω_pixel = (2π/W)(cos θ_r − cos θ_{r+1}),
and a sampled direction jittered uniformly in solid angle inside its pixel.
A constant envmap is a 1×1 map sampled uniformly over the sphere
(environmentmap.cpp:84-88). The tables are built on the host in numpy, as
the JAX package builds them; sample / eval / pdf run over ray wavefronts.
"""

from __future__ import annotations

import numpy as np
import torch

from optix_renderer_tpu_torch.core import dpdf as dpdf_mod
from optix_renderer_tpu_torch.core import warp
from optix_renderer_tpu_torch.core.math import INV_FOURPI, PI
from optix_renderer_tpu_torch.scene.data import DiscretePDF, EnvmapTables


def constant_tables(radiance) -> EnvmapTables:
    return EnvmapTables(img=torch.as_tensor(np.asarray(radiance, np.float32).reshape(1, 1, 3)),
                        rot=torch.eye(3, dtype=torch.float32))


def euler_zxz(angles_deg) -> np.ndarray:
    """PNGTexture.cpp:131-137 rotation: Rz(x)·Rx(y)·Rz(z), degrees."""
    ax, ay, az = np.radians(np.asarray(angles_deg, np.float64))

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    return (rz(ax) @ rx(ay) @ rz(az)).astype(np.float32)


def build_tables(image: np.ndarray, radiance, euler_deg=(0.0, 0.0, 0.0),
                 flip_v: bool = True) -> tuple[EnvmapTables, DiscretePDF]:
    """Orient the source image onto the lat-long grid and build the
    luminance·sinθ pixel distribution.

    `flip_v` replicates the reference texture's vertical flip
    (PNGTexture.cpp:148 `h = height − v·height`): oriented row r (θ grows
    downward from +z) reads source row (H−r) mod H.
    """
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    if flip_v and h > 1:
        rows = (h - np.arange(h)) % h
        img = img[rows]
    img = img * np.asarray(radiance, np.float32).reshape(1, 1, 3)

    lum = img @ np.array([0.212671, 0.715160, 0.072169], np.float32)  # color.h
    theta_edges = np.linspace(0.0, np.pi, h + 1, dtype=np.float64)
    # exact per-row pixel solid angle: (2π/W)(cosθ_r − cosθ_{r+1})
    omega_row = (2.0 * np.pi / w) * (np.cos(theta_edges[:-1]) - np.cos(theta_edges[1:]))
    weights = np.abs(lum) * omega_row[:, None].astype(np.float32)
    return (EnvmapTables(img=torch.as_tensor(img), rot=torch.as_tensor(euler_zxz(euler_deg))),
            dpdf_mod.build(weights.reshape(-1)))


def _dir_to_rc(env: EnvmapTables, d: torch.Tensor):
    """World direction → (row, col) on the oriented grid."""
    h, w = env.img.shape[0], env.img.shape[1]
    dm = d @ env.rot.T  # rotated into map space (PNGTexture rot * wi)
    theta = torch.arccos(torch.clamp(dm[..., 2], -1.0, 1.0))
    phi = torch.atan2(dm[..., 1], dm[..., 0])
    phi = torch.where(phi < 0.0, phi + 2.0 * PI, phi)
    r = torch.clamp((theta / PI * h).to(torch.int32), 0, h - 1).long()
    c = torch.clamp((phi / (2.0 * PI) * w).to(torch.int32), 0, w - 1).long()
    return r, c


def eval_dir(env: EnvmapTables, d: torch.Tensor) -> torch.Tensor:
    """Radiance arriving from directions `d` [N,3] (environmentmap.cpp:118-131)."""
    if env.img.shape[0] * env.img.shape[1] == 1:
        return env.img[0, 0].expand(d.shape[0], 3)
    r, c = _dir_to_rc(env, d)
    return env.img[r, c]


def _row_omega(env: EnvmapTables, r: torch.Tensor) -> torch.Tensor:
    h, w = env.img.shape[0], env.img.shape[1]
    rf = r.to(torch.float32)
    return (2.0 * PI / w) * (torch.cos(rf / h * PI) - torch.cos((rf + 1.0) / h * PI))


def pdf_dir(env: EnvmapTables, pick: DiscretePDF, d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of `sample_dir` producing direction `d`."""
    w = env.img.shape[1]
    if env.img.shape[0] * w == 1:
        return torch.full(d.shape[:-1], INV_FOURPI, dtype=torch.float32, device=d.device)
    r, c = _dir_to_rc(env, d)
    return pick.pmf[r * w + c] / torch.clamp(_row_omega(env, r), min=1e-12)


def sample_dir(env: EnvmapTables, pick: DiscretePDF, u2: torch.Tensor):
    """→ (direction [N,3] world, pdf [N], radiance [N,3])."""
    h, w = env.img.shape[0], env.img.shape[1]
    if h * w == 1:
        d = warp.square_to_uniform_sphere(u2)
        return d, pdf_dir(env, pick, d), env.img[0, 0].expand(d.shape[0], 3)
    # a pixel by luminance (sampleReuse frees u for the jitter inside it)
    idx, u_re = dpdf_mod.sample_reuse(pick, u2[..., 0])
    r = torch.div(idx, w, rounding_mode="floor")
    c = idx % w
    # uniform in solid angle inside the pixel: cosθ uniform in the row's band
    rf = r.to(torch.float32)
    cos0 = torch.cos(rf / h * PI)
    cos1 = torch.cos((rf + 1.0) / h * PI)
    ct = torch.clamp(cos0 + u_re * (cos1 - cos0), -1.0, 1.0)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    phi = (c.to(torch.float32) + u2[..., 1]) / w * (2.0 * PI)
    dm = torch.stack([st * torch.cos(phi), st * torch.sin(phi), ct], -1)
    d = dm @ env.rot  # the inverse rotation (rot is orthonormal)
    pdf = pick.pmf[idx] / torch.clamp(_row_omega(env, r), min=1e-12)
    return d, pdf, env.img[r, c]
