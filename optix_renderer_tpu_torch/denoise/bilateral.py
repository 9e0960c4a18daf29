"""Variance-guided cross-bilateral denoiser.

Counterpart of `optix_renderer_tpu/denoise/bilateral.py` (the reference's
src/denoiser/simple.cpp:29-115, Pham et al.): a spatial gaussian times the
range kernel exp(−½((‖Ip−Iq‖₁·σ_P)/σ_vr)²), run for `amount` passes, the
range kernel guided by the normalized per-pixel variance map
(`render/variance.py`). One stencil over shifted images, out-of-image
neighbours masked. It runs on the device of its inputs.
"""

from __future__ import annotations

import math

import torch


def denoise_bilateral(
    rgb: torch.Tensor,  # [H,W,3] normalized image
    variance: torch.Tensor,  # [H,W] normalized variance map
    sigma_d: float = 1.0,
    sigma_vr: float = 0.6,
    inner_range: int = 1,
    amount: int = 1,
) -> torch.Tensor:
    h, w, _ = rgb.shape
    img = rgb
    yy = torch.arange(h, device=rgb.device)[:, None]
    xx = torch.arange(w, device=rgb.device)[None, :]
    for _ in range(amount):
        num = torch.zeros_like(img)
        den = torch.zeros((h, w), dtype=img.dtype, device=img.device)
        for dy in range(-inner_range, inner_range + 1):
            for dx in range(-inner_range, inner_range + 1):
                shifted = torch.roll(img, shifts=(dy, dx), dims=(0, 1))
                valid = ((yy - dy >= 0) & (yy - dy < h) & (xx - dx >= 0)
                         & (xx - dx < w)).to(img.dtype)
                g = math.exp(-(dy * dy + dx * dx) / (2.0 * sigma_d * sigma_d))
                c_diff = torch.abs(img - shifted).sum(dim=-1)
                f = torch.exp(-0.5 * ((c_diff * variance) / sigma_vr) ** 2)
                wgt = g * f * valid
                num = num + shifted * wgt[..., None]
                den = den + wgt
        img = num / torch.clamp(den, min=1e-12)[..., None]
    return img
