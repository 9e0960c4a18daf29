"""Adaptive variance-guided sampling.

Counterpart of `optix_renderer_tpu/render/adaptive.py` (the reference's
src/samplers/adaptive.cpp, after Pajot et al.): uniform placement for the
first `adaptive_uniform_rounds` rounds, then each round draws its budget of
one sample per pixel from a distribution over the variance map of the whole
image, until the map is flat or stops improving (adaptive.cpp:95-128). The
rounds run on the scan path (`render.render_round_accumulate`), whose
intersections launch the port's kernels on a CUDA device (the shading
kernel's rule is asked once); the stop test reads the variance map on the
host once per round, as the JAX package does.

The draw's CDF is built on the host in float64 (`core/dpdf.build`), the JAX
package's in float32 by XLA, so a uniform that falls within a few ulps of
a cell boundary may pick the neighbouring pixel.
"""

from __future__ import annotations

import numpy as np
import torch

from optix_renderer_tpu_torch.core import dpdf, rng
from optix_renderer_tpu_torch.render import film as film_mod
from optix_renderer_tpu_torch.render import scan_graph
from optix_renderer_tpu_torch.render.render import (
    preprocess,
    render_round_accumulate,
    resolve_device,
)
from optix_renderer_tpu_torch.render.variance import variance_from_image
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData
from optix_renderer_tpu_torch.utils import tracing


def _draw_pixels(variance: torch.Tensor, round_idx: int, n: int, seed: int = 0) -> torch.Tensor:
    """n pixel ids [n] int64 drawn ∝ `variance` [H,W] (adaptive.cpp:152-166):
    lane i's uniform is the LCG's first float from tea(i, round ^ seed ^
    0xADA97), as in the JAX package."""
    d = dpdf.build(variance.detach().reshape(-1).cpu().numpy()).to(variance.device)
    lane = torch.arange(n, dtype=torch.int64, device=variance.device)
    key = (round_idx & rng.M32) ^ ((seed ^ 0xADA97) & rng.M32)
    _, u = rng.lcg_next_float(rng.tea(lane, key))
    return dpdf.sample(d, u)


@tracing.traced("render")
def render_adaptive(scene: SceneData, config: RenderConfig, sample_count: int | None = None,
                    verbose: bool = False, device="cuda") -> dict:
    """Adaptive render → numpy layers composite / albedo / normal / weights,
    the normalized `variance` map [H,W] and `samples_placed`."""
    with tracing.span("render.dispatch"):
        device = resolve_device(device)
        scene = preprocess(scene, config, device).to(device)
        spp = sample_count if sample_count is not None else config.sample_count
        w, h = config.width, config.height
        n_pix = w * h
        sc = scan_graph.shade_scene(scene, config, device)
        all_ids = torch.arange(n_pix, dtype=torch.int64, device=device)

        acc = torch.zeros((3, h, w, 4), dtype=torch.float32, device=device)
    # convergence state as adaptive.cpp:70-90: the old map starts at zero and
    # the norm guard high but finite, so the stop is armed from the second
    # adaptive round
    old_var = np.zeros((h, w), np.float32)
    old_norm = 1.0e4
    samples_placed = 0
    for r in range(spp):
        if r < config.adaptive_uniform_rounds:
            ids, sample_idx = all_ids, r
        else:
            var_img = variance_from_image(acc[0])
            var_np = var_img.cpu().numpy()
            if var_np.max() - var_np.min() <= 1e-12:
                break  # flat variance: converged (adaptive.cpp:96-102)
            # unit-norm the map (adaptive.cpp:104), so the stop does not
            # depend on the radiance scale
            var_unit = var_np / max(float(np.linalg.norm(var_np)), 1e-20)
            var_diff = float(np.abs(var_unit - old_var).sum())
            if var_diff > old_norm:
                break  # the variance stopped improving (adaptive.cpp:118-123)
            old_norm, old_var = var_diff, var_unit
            ids = _draw_pixels(var_img, r, n_pix, config.seed)
            # a pixel drawn twice in one round needs two streams: a virtual
            # sample index per lane (wraps mod 2^32 as the JAX int32 does)
            sample_idx = r * n_pix + all_ids
        render_round_accumulate(acc, scene, config, ids, sample_idx, sc)
        samples_placed += n_pix
        if verbose:
            print(f"  adaptive round {r + 1}/{spp}")

    with tracing.span("render.readout"):
        layers = film_mod.to_bitmap(acc).cpu().numpy()
        out = {
            "composite": layers[0],
            "albedo": layers[1],
            "normal": layers[2],
            "weights": acc[0, ..., 3].cpu().numpy(),
            "variance": variance_from_image(acc[0]).cpu().numpy(),
            "samples_placed": samples_placed,
        }
        tracing.fold_device()  # the copies have waited for the device
    return out
