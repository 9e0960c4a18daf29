"""Per-lane samplers for ray wavefronts.

Counterpart of `optix_renderer_tpu/render/sampler.py`: a `Sampler` holds one
pcg32 state per lane, seeded from `tea(pixel, sample ^ seed)` with the
pixel as stream, and `next_1d/2d/3d` advance it. The streams are bit-exact
with the JAX package (`core/rng.py`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from optix_renderer_tpu_torch.core import rng


class Sampler(NamedTuple):
    state: rng.Pcg32State  # batched pcg32


def make_sampler(pixel_idx: torch.Tensor, sample_idx, seed: int = 0) -> Sampler:
    """Deterministic per-lane sampler: initstate = tea(pixel, sample ^ seed),
    initseq = pixel."""
    pix = rng.u32(pixel_idx)
    smp = rng.u32(sample_idx, device=pix.device)
    h = rng.tea(pix, smp ^ (seed & rng.M32))
    zeros = torch.zeros_like(pix)
    return Sampler(state=rng.pcg32_seed(zeros, h, zeros, pix))


def next_1d(s: Sampler) -> tuple[Sampler, torch.Tensor]:
    state, u = rng.pcg32_next_float(s.state)
    return Sampler(state=state), u


def next_2d(s: Sampler) -> tuple[Sampler, torch.Tensor]:
    state, u1 = rng.pcg32_next_float(s.state)
    state, u2 = rng.pcg32_next_float(state)
    return Sampler(state=state), torch.stack([u1, u2], dim=-1)


def next_3d(s: Sampler) -> tuple[Sampler, torch.Tensor]:
    """[N,3] uniforms — 2D + 1D (volumelight.cpp:58-60 sample layout)."""
    s, u2 = next_2d(s)
    s, u1 = next_1d(s)
    return s, torch.cat([u2, u1[..., None]], dim=-1)
