"""Constant environment map: sample / eval / pdf.

The constant-envmap subset of `optix_renderer_tpu/ops/envmap.py` (a 1×1
lat-long map, environmentmap.cpp:84-88): uniform-sphere sampling with pdf
1/4π and the same radiance from every direction. Image-based envmaps are
ROADMAP Queue 1 item 8; the port's builder refuses them.
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core import warp
from optix_renderer_tpu_torch.core.math import INV_FOURPI


def eval_dir(radiance: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Radiance arriving from directions `d` [N,3] → [N,3]."""
    return radiance.expand(d.shape[0], 3)


def pdf_dir(d: torch.Tensor) -> torch.Tensor:
    """Solid-angle pdf of `sample_dir` producing direction `d`."""
    return torch.full(d.shape[:-1], INV_FOURPI, dtype=torch.float32, device=d.device)


def sample_dir(radiance: torch.Tensor, u2: torch.Tensor):
    """→ (direction [N,3] world, pdf [N], radiance [N,3])."""
    d = warp.square_to_uniform_sphere(u2)
    return d, pdf_dir(d), eval_dir(radiance, d)
