"""Discrete distributions: a numpy build, and sampling by binary search over the CDF.

Counterpart of `optix_renderer_tpu/core/dpdf.py` (dpdf.h:74-180): `build`
runs on the host for the scene builder (emitter pick, envmap pixels) and
gives a `scene.data.DiscretePDF`; `sample` / `sample_reuse` run over ray
wavefronts.
"""

from __future__ import annotations

import numpy as np
import torch

from optix_renderer_tpu_torch.scene.data import DiscretePDF


def build(weights) -> DiscretePDF:
    """From non-negative weights (append + normalize, dpdf.h:74-124), float32.

    The total and the CDF are accumulated in float64 and rounded once: a
    float32 running sum over an envmap's pixels drifts by ~1e-5 at 8,192
    entries, while XLA's blocked sums in the JAX package stay within a few
    ulps of the exact ones. So the two agree to ~2e-7 of the CDF, not bit for
    bit (tests/test_torch_surfaces.py).
    """
    w = np.maximum(np.asarray(weights, np.float32), np.float32(0))
    total = np.float32(w.astype(np.float64).sum())
    inv = np.float32(1.0) / max(total, np.float32(1e-38)) if total > 0 else np.float32(0)
    pmf = w * inv
    cdf = np.cumsum(pmf.astype(np.float64)).astype(np.float32)
    return DiscretePDF(pmf=torch.as_tensor(pmf), cdf=torch.as_tensor(cdf))


def sample(d, u: torch.Tensor) -> torch.Tensor:
    """Draw indices for uniform samples `u` (any batch shape)."""
    idx = torch.searchsorted(d.cdf, u.contiguous(), right=True)
    return torch.clamp(idx, 0, d.pmf.shape[0] - 1)


def sample_reuse(d, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """An index and `u` rescaled inside its cell, free for reuse (dpdf.h:166-180)."""
    idx = sample(d, u)
    lo = torch.where(idx > 0, d.cdf[torch.clamp(idx - 1, min=0)], 0.0)
    p = torch.clamp(d.pmf[idx], min=1e-38)
    return idx, torch.clamp((u - lo) / p, 0.0, 1.0 - 1e-7)
