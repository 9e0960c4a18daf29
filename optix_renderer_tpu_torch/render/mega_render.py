"""Render loop over the path kernel: sample groups → film accumulator.

Counterpart of `optix_renderer_tpu/render/mega_render.py`. Each group of up
to `_GROUP` samples per pixel is one `pathk_trace` call; its
`[16, n_pix]` rows are sanitised (`nan_to_num`) and added into the
`[3, H, W, 4]` accumulator (layers composite / albedo / normal; channel 3
holds the samples per pixel). Previews and checkpoints fire when at least
`every` samples have been added since the last one, so cadences that are
not multiples of each other skip none.
"""

from __future__ import annotations

import os
import time

import torch

from optix_renderer_tpu_torch.ops.cuda import pathk
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData

# composite rgb, albedo rgb, normal rgb rows of the kernel output
_LAYER_ROWS = [0, 1, 2, 4, 5, 6, 7, 8, 9]
# samples per pixel in one kernel launch (fewer when previews or checkpoints
# come more often)
_GROUP = 16


def _pathk_group(acc, tables, meta, config, spp0: int, n_spp: int) -> None:
    """Trace one group of samples and add it into `acc` in place."""
    h, w = config.height, config.width
    out = pathk.pathk_trace(tables, meta, config, n_pix=w * h, spp0=spp0, n_spp=n_spp)
    out = torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)
    acc[..., :3] += out[_LAYER_ROWS].reshape(3, 3, h, w).permute(0, 2, 3, 1)
    acc[..., 3] += out[3].reshape(1, h, w)


def render_mega(
    scene: SceneData,
    config: RenderConfig,
    *,
    device: torch.device,
    sample_count: int | None = None,
    verbose: bool = False,
    preview_every: int = 0,
    preview_callback=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> dict:
    """Full render through the path kernel. Same contract as `render.render`."""
    from optix_renderer_tpu_torch.render.render import (
        _layers_out,
        _norm_ckpt_path,
        load_checkpoint,
        save_checkpoint,
    )

    spp = sample_count if sample_count is not None else config.sample_count
    tables, meta = pathk.build_pathk_tables(scene, config, device)

    acc = torch.zeros((3, config.height, config.width, 4), dtype=torch.float32, device=device)
    start_spp = 0
    if resume and checkpoint_path and os.path.exists(_norm_ckpt_path(checkpoint_path)):
        acc, start_spp = load_checkpoint(checkpoint_path, config, device)
        if verbose:
            print(f"  resumed at sample {start_spp} from {checkpoint_path}")

    group = _GROUP
    if preview_every:
        group = min(group, preview_every)
    if checkpoint_every:
        group = min(group, checkpoint_every)

    t0 = time.time()
    spp_done = last_preview = last_ckpt = start_spp
    try:
        while spp_done < spp:
            n_r = min(group, spp - spp_done)
            _pathk_group(acc, tables, meta, config, spp_done, n_r)
            spp_done += n_r
            if verbose:
                if acc.is_cuda:
                    torch.cuda.synchronize(acc.device)
                print(f"  sample {spp_done}/{spp}  ({time.time() - t0:.1f}s)")
            if preview_every and preview_callback and spp_done - last_preview >= preview_every:
                preview_callback(_layers_out(acc), spp_done)
                last_preview = spp_done
            if checkpoint_path and checkpoint_every and spp_done - last_ckpt >= checkpoint_every:
                save_checkpoint(checkpoint_path, acc, spp_done, config)
                last_ckpt = spp_done
    except KeyboardInterrupt:
        if verbose:
            print(f"  interrupted at sample {spp_done}/{spp} — partial film returned")

    if checkpoint_path and spp_done >= spp:
        save_checkpoint(checkpoint_path, acc, spp_done, config)
    out = _layers_out(acc)
    out["spp_done"] = spp_done
    return out
