"""Perspective camera: projection matrix and ray generation.

Counterpart of `optix_renderer_tpu/ops/camera.py`. The path kernel reads
`sample_to_camera_matrix` from its float scalar pack and makes its rays
itself (`ops/cuda/pathk.py: _camera_ray`); the general path calls
`sample_ray` (perspective.cpp:97-141).
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core import warp
from optix_renderer_tpu_torch.core.math import EPSILON, Ray, normalize
from optix_renderer_tpu_torch.scene.data import Camera

PI = 3.14159265358979


def sample_to_camera_matrix(cam: Camera, width: int, height: int) -> torch.Tensor:
    """Inverse of (screen-shift ∘ perspective), float32 [4,4]."""
    f32 = torch.float32
    far = cam.far_clip.to(f32)
    near = cam.near_clip.to(f32)
    aspect = width / height
    recip = 1.0 / (far - near)
    cot = 1.0 / torch.tan(cam.fov.to(f32) * (PI / 180.0) / 2.0)
    persp = torch.zeros((4, 4), dtype=f32, device=far.device)
    persp[0, 0] = cot
    persp[1, 1] = cot
    persp[2, 2] = far * recip
    persp[2, 3] = -near * far * recip
    persp[3, 2] = 1.0
    screen = torch.tensor(
        [[0.5, 0, 0, 0.5], [0, -0.5 * aspect, 0, 0.5], [0, 0, 1, 0], [0, 0, 0, 1]],
        dtype=f32, device=far.device,
    )
    return torch.linalg.inv(screen @ persp)


def _xform_point(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Homogeneous transform of points [N,3] by the [4,4] matrix m."""
    r = [p[:, 0] * m[i, 0] + p[:, 1] * m[i, 1] + p[:, 2] * m[i, 2] + m[i, 3] for i in range(4)]
    return torch.stack(r[:3], dim=-1) / r[3][:, None]


def _xform_vector(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.stack([v[:, 0] * m[i, 0] + v[:, 1] * m[i, 1] + v[:, 2] * m[i, 2]
                        for i in range(3)], dim=-1)


def sample_ray(cam: Camera, width: int, height: int, sample_position: torch.Tensor,
               aperture_sample: torch.Tensor, *, s2c: torch.Tensor | None = None
               ) -> tuple[Ray, torch.Tensor]:
    """sample_position: [N,2] continuous pixel coords; aperture: [N,2] in [0,1)².
    `s2c`: `sample_to_camera_matrix` of `cam` on the samples' device, made
    here when None (a copy to the host and back, which waits for the device).

    Returns (ray, importance weight [N,3]); the weight is 1 (perspective.cpp:140).
    """
    f32 = torch.float32
    sp = sample_position
    # inverted on the host, so a CUDA and a CPU render share the same matrix
    if s2c is None:
        s2c = sample_to_camera_matrix(cam.to("cpu"), width, height).to(sp.device)
    near_p = _xform_point(s2c, torch.stack(
        [sp[:, 0] / width, sp[:, 1] / height, torch.zeros_like(sp[:, 0])], dim=-1))
    d_local = normalize(near_p)

    # thin-lens DoF (perspective.cpp:113-130), branch-free on lensRadius
    lens_radius = cam.lens_radius.to(f32)
    p_lens2 = lens_radius * warp.square_to_uniform_disk(aperture_sample)
    p_lens = torch.cat([p_lens2, torch.zeros_like(p_lens2[:, :1])], dim=-1)
    ft = cam.focal_distance.to(f32) / d_local[:, 2:3]
    d_dof = normalize(d_local * ft - p_lens)
    use_dof = lens_radius > EPSILON
    o_local = torch.where(use_dof, p_lens, torch.zeros_like(d_local))
    d_final = torch.where(use_dof, d_dof, d_local)

    to_world = cam.to_world.to(f32)
    inv_z = 1.0 / d_local[:, 2]
    ray = Ray(o=_xform_point(to_world, o_local), d=_xform_vector(to_world, d_final),
              mint=cam.near_clip.to(f32) * inv_z, maxt=cam.far_clip.to(f32) * inv_z)
    return ray, torch.ones_like(near_p)
