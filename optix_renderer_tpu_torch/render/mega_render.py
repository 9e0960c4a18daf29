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


def _pathk_group(acc, tables, meta, config, spp0: int, n_spp: int, pix0: int = 0,
                 n_pix: int | None = None) -> None:
    """Trace one group of samples for pixels [pix0, pix0 + n_pix) of the image
    (by default all of them) on the tables' device, and add the rows into
    those pixels of `acc` in place, on its device (the sharded render's
    gather, `parallel/shard.py`). Each pixel's sums are added alone, so
    ranges traced apart give the film of one whole-image call bit for bit."""
    h, w = config.height, config.width
    n_pix = h * w - pix0 if n_pix is None else n_pix
    out = pathk.pathk_trace(tables, meta, config, n_pix=n_pix, spp0=spp0, n_spp=n_spp,
                            pix0=pix0).to(acc.device)
    out = torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)
    px = acc.view(3, h * w, 4)[:, pix0:pix0 + n_pix]
    px[..., :3] += out[_LAYER_ROWS].reshape(3, 3, n_pix).transpose(1, 2)
    px[..., 3] += out[3]


def mega_step(scene: SceneData, config: RenderConfig, device: torch.device):
    """Pack the kernel's tables → `step(acc, spp0, n_spp)`, which adds
    samples spp0 … spp0 + n_spp − 1 of every pixel into `acc`."""
    tables, meta = pathk.build_pathk_tables(scene, config, device)

    def step(acc, spp0: int, n_spp: int) -> None:
        _pathk_group(acc, tables, meta, config, spp0, n_spp)

    return step
