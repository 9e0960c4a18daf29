"""Texture evaluation over the texture table (constant textures).

Counterpart of `optix_renderer_tpu/ops/texture.py: eval_texture` for the
only kind the port's builder accepts (consttexture.cpp); checkerboard and
image textures are ROADMAP Queue 1 item 8. `tex_id [N]`, `uv [N,2]` →
color `[N,3]`; an id < 0 is white.
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.scene.data import Textures


def eval_texture(tex: Textures, tex_id: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    del uv  # constant textures do not depend on it
    out = tex.value[torch.clamp(tex_id, min=0).long()]
    return torch.where(tex_id[..., None] < 0, 1.0, out)
