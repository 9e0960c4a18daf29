"""Gradients of an image loss with respect to the scene's parameters.

Counterpart of the training half of `optix_renderer_tpu/parallel/shard.py`
(:354-410): `trainable_params` / `apply_params` name the four parameter
tables (texture values, diffuse `kd`, microfacet `alpha`, emitter
radiance), and `train_step` is the one-device case of the JAX
`sharded_train_step`: one `render_round` of the scan path, `to_bitmap`, the
mean squared error against a target, and its gradients by autograd.

The forward launches the port's kernels (`isect_brute`, `isect_bvh`, the
tracking kernel) on detached inputs and replays their discrete choices in
torch (`ops/intersect.py`, `ops/volume_grid.py`), so the backward runs
torch only. Derived tables (the emitter pick, the envmap tables, the path
kernel's packing) stay as built, as in the JAX package. The multi-device
pieces, `make_mesh`, `render_sharded` and `sharded_train_step`, are not
here: they are ROADMAP Queue 1 item 12.
"""

from __future__ import annotations

import dataclasses

import torch

from optix_renderer_tpu_torch.render import film
from optix_renderer_tpu_torch.render.render import render_round, resolve_device
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData


def trainable_params(scene: SceneData) -> dict[str, torch.Tensor]:
    """The differentiable parameters by name (shard.py:354-363)."""
    return {
        "tex_value": scene.textures.value,
        "bsdf_kd": scene.bsdfs.kd,
        "bsdf_alpha": scene.bsdfs.alpha,
        "em_radiance": scene.emitters.radiance,
    }


def apply_params(scene: SceneData, params: dict[str, torch.Tensor]) -> SceneData:
    """The scene with the four parameter tables replaced (shard.py:366-372)."""
    return dataclasses.replace(
        scene,
        textures=dataclasses.replace(scene.textures, value=params["tex_value"]),
        bsdfs=dataclasses.replace(scene.bsdfs, kd=params["bsdf_kd"],
                                  alpha=params["bsdf_alpha"]),
        emitters=dataclasses.replace(scene.emitters, radiance=params["em_radiance"]),
    )


def train_step(scene: SceneData, config: RenderConfig, target: torch.Tensor, pixel_ids,
               sample_base: int, device="cuda") -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, grads) of mean((to_bitmap(render_round(...))[0] − target)²)
    with respect to `trainable_params(scene)`, for the lanes `pixel_ids` [N]
    (negative ids are padding) at sample `sample_base`. The scene's tables
    are the parameters' current values; a parameter the loss does not reach
    gets a zero gradient."""
    device = resolve_device(device)
    scene = scene.to(device)
    params = {k: v.detach().requires_grad_(True) for k, v in trainable_params(scene).items()}
    img = render_round(apply_params(scene, params), config, pixel_ids.to(device), sample_base)
    loss = torch.mean((film.to_bitmap(img)[0] - target.to(device)) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(p) if g is None else g
                           for (k, p), g in zip(params.items(), grads)}

