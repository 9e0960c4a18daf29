"""Learned denoiser: a small residual conv net over RGB + albedo + normal.

Counterpart of `optix_renderer_tpu/denoise/learned.py` (the replacement of
the reference's OptiX AI denoiser, OptixState.denoiser.cpp:15-152: HDR
radiance with albedo and normal feature buffers in, radiance out). Four
3×3 convolutions predict a residual over the log-compressed radiance; the
net trains on self-rendered noisy / clean pairs with Adam.

Layouts: the JAX package keeps images NHWC and weights HWIO
(`lax.conv_general_dilated`, SAME padding); here the convolutions are
`torch.nn.functional.conv2d` on NCHW images with OIHW weights and padding
1, the same cross-correlation. `apply` keeps the JAX interface ([H,W,3] or
[B,H,W,3] in and out). Parameters are a dict `w0..w3` (OIHW), `b0..b3`;
`params_from_numpy` / `params_to_numpy` convert from / to the JAX layout,
and the `.npz` checkpoints hold the JAX layout, so each package reads the
other's.

The JAX package computes the convolutions with XLA, not in a Pallas
kernel, so the library's convolution is the counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from optix_renderer_tpu_torch.render.render import _norm_ckpt_path, render, resolve_device

# (in_ch, out_ch) per layer; input = RGB(3) + albedo(3) + normal(3)
_LAYERS = ((9, 32), (32, 32), (32, 16), (16, 3))
_KSIZE = 3


def params_from_numpy(params, device="cpu") -> dict:
    """JAX-layout parameters (`w{i}` HWIO [3,3,in,out], `b{i}` [out], numpy
    or anything numpy converts) → this package's (`w{i}` OIHW) float32
    tensors on `device`."""
    out = {}
    for k, v in params.items():
        t = torch.as_tensor(np.array(v, np.float32))
        out[k] = (t.permute(3, 2, 0, 1) if k.startswith("w") else t).contiguous().to(device)
    return out


def params_to_numpy(params) -> dict:
    """This package's parameters → the JAX layout as numpy float32."""
    return {k: (v.detach().permute(2, 3, 1, 0) if k.startswith("w") else v.detach())
            .cpu().numpy().astype(np.float32) for k, v in params.items()}


def init_params(seed: int = 0, device="cuda") -> dict:
    """He-initialized parameters: w ~ N(0, 2 / (in·3·3)) from a
    `torch.Generator` seeded with `seed`, b = 0. (JAX's `jax.random` draws
    cannot be reproduced here, so the two packages start from different
    weights for one seed; carry JAX's across with `params_from_numpy`.)"""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for i, (cin, cout) in enumerate(_LAYERS):
        scale = float(np.sqrt(2.0 / (cin * _KSIZE * _KSIZE)))
        w = torch.randn((cout, cin, _KSIZE, _KSIZE), generator=gen) * scale
        params[f"w{i}"] = w.to(device)
        params[f"b{i}"] = torch.zeros(cout, device=device)
    return params


def _relu_floor(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) whose gradient splits a tie as `jnp.maximum`'s does."""
    return torch.maximum(x, torch.zeros_like(x))


def apply(params: dict, rgb, albedo, normal) -> torch.Tensor:
    """Denoise [H,W,3] (or a batch [B,H,W,3]) → the same shape.

    HDR radiance is log-compressed before the net and re-expanded after
    (the trick the OptiX HDR model hides behind `computeIntensity`,
    OptixState.denoiser.cpp:123-135)."""
    squeeze = rgb.dim() == 3
    if squeeze:
        rgb, albedo, normal = rgb[None], albedo[None], normal[None]
    lum = torch.log1p(_relu_floor(rgb))
    x = torch.cat([lum, albedo, normal], dim=-1).permute(0, 3, 1, 2)  # NCHW
    n_layers = len(_LAYERS)
    for i in range(n_layers):
        x = F.conv2d(x, params[f"w{i}"], params[f"b{i}"], padding=1)
        if i < n_layers - 1:
            x = torch.relu(x)
    out = torch.expm1(_relu_floor(lum + x.permute(0, 2, 3, 1)))  # residual in log space
    return out[0] if squeeze else out


def loss_fn(params: dict, rgb, albedo, normal, clean) -> torch.Tensor:
    """Log-space L1 (robust to fireflies, which dominate an L2 in HDR)."""
    pred = apply(params, rgb, albedo, normal)
    return torch.mean(torch.abs(torch.log1p(_relu_floor(pred))
                                - torch.log1p(_relu_floor(clean))))


def adam(params: dict, lr: float) -> torch.optim.Adam:
    """`optax.adam(lr)`'s update: β 0.9 / 0.999, ε 1e-8 outside the square root."""
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train(pairs, steps: int = 200, lr: float = 2e-3, seed: int = 0, verbose: bool = False,
          device="cuda"):
    """Full-batch `adam` over `pairs` (dicts of rgb / albedo / normal / clean,
    [H,W,3] numpy) on `device`, from `init_params(seed)` → (params, losses)."""
    device = resolve_device(device)
    params = {k: v.requires_grad_(True) for k, v in init_params(seed, device).items()}

    def stack(key):
        return torch.stack([torch.as_tensor(np.asarray(p[key], np.float32)) for p in pairs]).to(
            device)

    rgb, alb, nrm, cln = stack("rgb"), stack("albedo"), stack("normal"), stack("clean")
    opt = adam(params, lr)
    losses = []
    for i in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, rgb, alb, nrm, cln)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if verbose and (i % 20 == 0 or i == steps - 1):
            print(f"  denoiser step {i}: loss {losses[-1]:.5f}")
    return {k: v.detach() for k, v in params.items()}, losses


# -- checkpoints: a flat .npz of the JAX layout (np.savez adds a missing suffix) --


def save_checkpoint(path, params: dict) -> None:
    np.savez(_norm_ckpt_path(str(path)), **params_to_numpy(params))


def load_checkpoint(path, device="cuda") -> dict:
    """A checkpoint written by either package → parameters on `device`."""
    device = resolve_device(device)
    with np.load(_norm_ckpt_path(str(path))) as z:
        return params_from_numpy({k: z[k] for k in z.files}, device)


def render_training_pairs(scene, config, spps=(2, 4), clean_spp=256, seeds=(0, 1),
                          device="cuda") -> list:
    """Noisy / clean AOV pairs of one scene, rendered by `render()` on
    `device`: the clean film at `clean_spp` with seed 1234, a noisy one per
    (spp, seed)."""
    clean = render(scene, dataclasses.replace(config, seed=1234), sample_count=clean_spp,
                   device=device)
    pairs = []
    for spp in spps:
        for seed in seeds:
            noisy = render(scene, dataclasses.replace(config, seed=seed), sample_count=spp,
                           device=device)
            pairs.append(dict(rgb=noisy["composite"], albedo=noisy["albedo"],
                              normal=noisy["normal"], clean=clean["composite"]))
    return pairs
