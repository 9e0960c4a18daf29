"""Render entry point: `render()` dispatch, film readout, checkpoints.

Counterpart of `optix_renderer_tpu/render/render.py`. The JAX package takes
its path kernel only on a TPU and otherwise runs its XLA integrators; this
package has only the path-kernel contract so far, so `render()` always
takes it: on a CUDA device it launches the CUDA kernel, on the CPU it runs
the kernel's plain torch version. A scene the kernel does not cover raises
`NotImplementedError` naming the ROADMAP item, and a CUDA device without a
GPU raises; nothing falls back.

Layer order matches ERenderLayer (integrator.h:29-39):
0 = composite, 1 = albedo, 2 = normal.
"""

from __future__ import annotations

import numpy as np
import torch

from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData


def _norm_ckpt_path(path: str) -> str:
    """np.savez appends '.npz' when the suffix is missing; use that name both ways."""
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, acc, spp_done: int, config: RenderConfig) -> None:
    """Persist the running accumulator (same file format as the JAX package)."""
    np.savez(
        _norm_ckpt_path(path),
        acc=acc.detach().cpu().numpy(),
        spp_done=np.int64(spp_done),
        shape_key=np.array([config.width, config.height], np.int64),
        seed=np.int64(config.seed),
    )


def load_checkpoint(path: str, config: RenderConfig, device="cpu"):
    """Load (acc on `device`, spp_done); raises on resolution/seed mismatch."""
    with np.load(_norm_ckpt_path(path)) as z:
        wh = z["shape_key"]
        if (int(wh[0]), int(wh[1])) != (config.width, config.height):
            raise ValueError(f"checkpoint is {wh[0]}x{wh[1]}, render is "
                             f"{config.width}x{config.height}")
        if int(z["seed"]) != config.seed:
            raise ValueError("checkpoint seed differs — sample streams diverge")
        return torch.from_numpy(z["acc"]).to(device), int(z["spp_done"])


def _layers_out(acc) -> dict[str, np.ndarray]:
    """[3,H,W,4] accumulator → numpy layers. On the path-kernel path channel 3
    counts samples, so `weights` is the number of samples per pixel."""
    a = acc.detach().cpu().numpy()
    w = a[..., 3:4]
    layers = np.where(w > 1e-9, a[..., :3] / np.maximum(w, 1e-9), 0.0)
    return {
        "composite": layers[0],
        "albedo": layers[1],
        "normal": layers[2],
        "weights": a[0, ..., 3],
    }


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device without a GPU raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def render(
    scene: SceneData,
    config: RenderConfig,
    sample_count: int | None = None,
    *,
    device="cuda",
    verbose: bool = False,
    preview_every: int = 0,
    preview_callback=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> dict:
    """Full render; returns numpy layers composite / albedo / normal /
    weights and `spp_done`.

    - `preview_every=k` + `preview_callback(layers, spp_done)` fetches the
      partial film after every k samples;
    - `checkpoint_path` (+ `checkpoint_every=k`) snapshots the accumulator;
      `resume=True` continues from an existing snapshot;
    - SIGINT between sample groups returns the partial film with
      `spp_done < spp`.
    """
    from optix_renderer_tpu_torch.ops.cuda.pathk import pathk_unsupported
    from optix_renderer_tpu_torch.render.mega_render import render_mega

    device = resolve_device(device)
    reason = pathk_unsupported(scene, config)
    if reason is not None:
        raise NotImplementedError(reason)
    return render_mega(
        scene, config, device=device, sample_count=sample_count, verbose=verbose,
        preview_every=preview_every, preview_callback=preview_callback,
        checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every, resume=resume,
    )
