"""The path kernel's sample step for `render.render`'s loop.

Counterpart of `optix_renderer_tpu/render/mega_render.py`. Each group of up
to `GROUP` samples per pixel is one `pathk_trace` call; its `[16, n_pix]`
rows are sanitised (`nan_to_num`) and added into the `[3, H, W, 4]`
accumulator (layers composite / albedo / normal; channel 3 holds the
samples per pixel).
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.ops.cuda import pathk
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData

# composite rgb, albedo rgb, normal rgb rows of the kernel output
_LAYER_ROWS = [0, 1, 2, 4, 5, 6, 7, 8, 9]
# samples per pixel in one kernel launch (fewer when previews or checkpoints
# come more often)
GROUP = 16


def _pathk_group(acc, tables, meta, config, spp0: int, n_spp: int) -> None:
    """Trace one group of samples and add it into `acc` in place."""
    h, w = config.height, config.width
    out = pathk.pathk_trace(tables, meta, config, n_pix=w * h, spp0=spp0, n_spp=n_spp)
    out = torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)
    acc[..., :3] += out[_LAYER_ROWS].reshape(3, 3, h, w).permute(0, 2, 3, 1)
    acc[..., 3] += out[3].reshape(1, h, w)


def mega_step(scene: SceneData, config: RenderConfig, device: torch.device):
    """Pack the kernel's tables → `step(acc, spp0, n_spp)`, which adds
    samples spp0 … spp0 + n_spp − 1 of every pixel into `acc`."""
    tables, meta = pathk.build_pathk_tables(scene, config, device)

    def step(acc, spp0: int, n_spp: int) -> None:
        _pathk_group(acc, tables, meta, config, spp0, n_spp)

    return step
