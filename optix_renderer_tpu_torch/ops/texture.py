"""Texture evaluation over the tagged-union texture table.

Counterpart of `optix_renderer_tpu/ops/texture.py: eval_texture` (the
reference consttexture / checkerboard / PNGTexture `eval(uv)`): `tex_id
[N]`, `uv [N,2]` → color `[N,3]`, every kind evaluated and selected by type;
an id < 0 is white. Kinds absent from the table (`Textures.kinds`) are
not evaluated: the selection would not pick them. The checker parity and the image's repeat wrap are
floor-mods, as the JAX `%` is: `torch.remainder`, not `fmod`, so negative
uv wrap the same way.
"""

from __future__ import annotations

import torch

from optix_renderer_tpu_torch.core.math import rows
from optix_renderer_tpu_torch.scene.data import Textures, TextureType


def eval_texture(tex: Textures, tex_id: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    tid = torch.clamp(tex_id, min=0).long()
    out = v1 = rows(tex.value, tid)
    if tex.kinds != (TextureType.CONST,):
        ttype = tex.type[tid]
        scale = tex.scale_uv[tid]
    if TextureType.IMAGE in tex.kinds:
        # image (PNGTexture.cpp): repeat wrap, nearest texel, linear values
        iid = torch.clamp(tex.image_id[tid], min=0).long()
        hw = tex.image_hw[iid]
        u_wrapped = torch.remainder(uv[..., 0] * scale[..., 0], 1.0)
        v_wrapped = torch.remainder(uv[..., 1] * scale[..., 1], 1.0)
        x = torch.minimum(torch.clamp((u_wrapped * hw[..., 1].to(torch.float32)).to(torch.int32),
                                      min=0), hw[..., 1] - 1)
        y = torch.minimum(torch.clamp((v_wrapped * hw[..., 0].to(torch.float32)).to(torch.int32),
                                      min=0), hw[..., 0] - 1)
        image = tex.image_data[iid, y.long(), x.long()]
        out = torch.where((ttype == TextureType.IMAGE)[..., None], image, out)
    if TextureType.CHECKER in tex.kinds:
        # checkerboard (checkerboard.cpp): parity of floor((uv − delta) / scale)
        st = (uv - tex.shift_uv[tid]) / torch.clamp(scale, min=1e-20)
        parity = torch.remainder(
            (torch.floor(st[..., 0]) + torch.floor(st[..., 1])).to(torch.int32), 2)
        checker = torch.where((parity == 0)[..., None], v1, tex.value2[tid])
        out = torch.where((ttype == TextureType.CHECKER)[..., None], checker, out)
    return torch.where(tex_id[..., None] < 0, 1.0, out)
