"""Perspective camera projection (perspective.cpp:69-95).

Counterpart of `optix_renderer_tpu/ops/camera.py: sample_to_camera_matrix`.
The kernel reads the result from its float scalar pack; rays themselves are
made in the kernel (`ops/cuda/pathk.py: _camera_ray`).
"""

from __future__ import annotations

import torch

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
