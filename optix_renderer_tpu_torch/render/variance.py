"""Per-pixel variance estimation from the accumulated film.

Counterpart of `optix_renderer_tpu/render/variance.py` (the reference's
`computeVarianceFromImage`, src/utils/common.cpp:339-399): 3×3 local
variance of luminance with out-of-image neighbours excluded, then the
reference's 1 + 0.254·minmax normalization. Drives the adaptive sampler
(`render/adaptive.py`) and is written as `<scene>_variance.exr`.
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core.math import EPSILON, luminance


def _shift2d(x: torch.Tensor, dy: int, dx: int):
    """Shift with validity mask (out-of-bounds neighbours are excluded, not
    clamped: common.cpp:353-356 `continue`s on clamped indices)."""
    h, w = x.shape
    rolled = torch.roll(x, shifts=(dy, dx), dims=(0, 1))
    yy = torch.arange(h, device=x.device)[:, None]
    xx = torch.arange(w, device=x.device)[None, :]
    valid = (yy - dy >= 0) & (yy - dy < h) & (xx - dx >= 0) & (xx - dx < w)
    return rolled, valid.to(x.dtype)


def local_variance(lum: torch.Tensor) -> torch.Tensor:
    """3×3 masked local variance of a luminance image [H,W]."""
    s = torch.zeros_like(lum)
    s2 = torch.zeros_like(lum)
    cnt = torch.zeros_like(lum)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            v, m = _shift2d(lum, dy, dx)
            s = s + v * m
            s2 = s2 + v * v * m
            cnt = cnt + m
    mean = s / cnt
    return torch.clamp(s2 / cnt - mean * mean, min=0.0)


def variance_from_image(film: torch.Tensor) -> torch.Tensor:
    """Weighted film [H,W,4] → normalized variance [H,W] (common.cpp:339-399):
    0 everywhere when flat, else 1 + 0.254·(v−min)/(max−min)."""
    w = torch.clamp(film[..., 3], min=1e-9)
    rgb = film[..., :3] / w[..., None]
    var = local_variance(torch.abs(luminance(rgb)))
    vmax, vmin = var.max(), var.min()
    norm = 1.0 + (var - vmin) / torch.clamp(vmax - vmin, min=1e-20) * 0.254
    return torch.where((vmax - vmin) < EPSILON, torch.zeros_like(var), norm)
