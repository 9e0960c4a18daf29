"""Discrete distributions: sampling by binary search over the CDF.

Counterpart of `optix_renderer_tpu/core/dpdf.py: sample` (dpdf.h:140-152);
the distributions themselves are built by the scene builder
(`scene/build.py: _dpdf`) into `scene.data.DiscretePDF`.
"""

from __future__ import annotations

import torch


def sample(d, u: torch.Tensor) -> torch.Tensor:
    """Draw indices for uniform samples `u` (any batch shape)."""
    idx = torch.searchsorted(d.cdf, u.contiguous(), right=True)
    return torch.clamp(idx, 0, d.pmf.shape[0] - 1)
