"""Render entry point: `render()` dispatch, the scan path, film readout,
checkpoints.

Counterpart of `optix_renderer_tpu/render/render.py`, dispatched as the JAX
package dispatches (render.py:203-224), with no gate on the device: a scene
the path kernel takes (`pathk_eligible`) goes to `mega_render.mega_step`,
every other scene, or any scene with `mega=False`, to the scan path below;
one sample loop drives either. The scan path renders one sample round at a
time over chunks of up to `MAX_LANES` pixels: camera rays, the
integrator's bounce loop (`integrators/`), whose intersections launch the
kernels of `csrc/isect.cu` on a CUDA device and run their plain torch
versions on the CPU, and the filter splat (`render/film.py`). A CUDA device without a GPU raises; nothing falls back.

Layer order matches ERenderLayer (integrator.h:29-39):
0 = composite, 1 = albedo, 2 = normal.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from optix_renderer_tpu_torch.integrators import get_integrator
from optix_renderer_tpu_torch.ops import camera as camera_ops
from optix_renderer_tpu_torch.render import film
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData

# Upper bound on rays in flight per chunk: at 2^19 lanes an 800×600 frame is
# one chunk per sample round, as in the JAX package (render.py:35).
MAX_LANES = 1 << 19


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
    counts samples, so `weights` is the number of samples per pixel; on the
    scan path it sums filter weights."""
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


def _round_layers(scene: SceneData, config: RenderConfig, pixel_ids, sample_idx: int):
    """One sample for a chunk of pixels → (pos [N,2], layers [3,N,3])
    (renderBlock, render.cpp:421-459: per-pixel jitter, camera ray, Li)."""
    px = (pixel_ids % config.width).to(torch.float32)
    py = (pixel_ids // config.width).to(torch.float32)
    s = smp.make_sampler(pixel_ids, sample_idx, seed=config.seed)
    s, jitter = smp.next_2d(s)
    s, aperture = smp.next_2d(s)
    pos = torch.stack([px, py], dim=-1) + jitter
    ray, _ = camera_ops.sample_ray(scene.camera, config.width, config.height, pos, aperture)
    L, albedo, normal, _ = get_integrator(config.integrator)(scene, config, ray, s)
    # a dead lane's NaN / Inf must not poison the film
    L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
    return pos, torch.stack([L, albedo, normal])


def render_round_accumulate(acc, scene: SceneData, config: RenderConfig, pixel_ids,
                            sample_idx: int) -> None:
    """One sample round for `pixel_ids` [N] int64 (negative ids are padding
    lanes, outside the image), splatted into `acc` [3,H,W,4] in place."""
    pos, layers = _round_layers(scene, config, pixel_ids, sample_idx)
    film.splat_(acc, config.rfilter, pos, layers)


def scan_step(scene: SceneData, config: RenderConfig, device: torch.device):
    """The scan path (render.py:246-302 of the JAX package) →
    `step(acc, spp0, n_spp)`, which renders sample rounds spp0 …
    spp0 + n_spp − 1, each over chunks of up to `MAX_LANES` pixels."""
    get_integrator(config.integrator)  # an integrator not ported yet raises here
    scene = scene.to(device)
    w, h = config.width, config.height
    n_pix = w * h
    chunk = min(MAX_LANES, n_pix)
    n_chunks = (n_pix + chunk - 1) // chunk
    pad = n_chunks * chunk - n_pix
    # padding lanes sit far outside the image, so their splat adds nothing
    ids = torch.cat([torch.arange(n_pix, dtype=torch.int64),
                     torch.full((pad,), -max(w, h) * 4, dtype=torch.int64)]).to(device)

    def step(acc, spp0: int, n_spp: int) -> None:
        for s_idx in range(spp0, spp0 + n_spp):
            for c in range(n_chunks):
                render_round_accumulate(acc, scene, config, ids[c * chunk:(c + 1) * chunk],
                                        s_idx)

    return step


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
    mega: bool | None = None,
    wavefront: bool | None = None,
) -> dict:
    """Full render; returns numpy layers composite / albedo / normal /
    weights and `spp_done`.

    - `mega=False` forces the scan path even for a scene the path kernel
      takes;
    - `preview_every=k` + `preview_callback(layers, spp_done)` fetches the
      partial film after every k samples;
    - `checkpoint_path` (+ `checkpoint_every=k`) snapshots the accumulator;
      `resume=True` continues from an existing snapshot;
    - SIGINT returns the partial film with `spp_done < spp`, and writes the
      checkpoint when it came between two steps.

    Both paths run the one loop below; each gives a `step(acc, spp0, n)`
    that adds n samples per pixel, and the samples one step may take
    (`mega_render.GROUP` for the path kernel, one sample round for the scan
    path, fewer when previews or checkpoints come more often).
    """
    from optix_renderer_tpu_torch.ops.cuda.pathk import pathk_eligible
    from optix_renderer_tpu_torch.render.mega_render import GROUP, mega_step

    device = resolve_device(device)
    if wavefront:
        raise NotImplementedError("wavefront (path-regeneration) mode is not ported: ROADMAP "
                                  "Queue 1 'Leave out' (render/wavefront.py)")
    if config.adaptive:
        raise NotImplementedError("adaptive sampling: ROADMAP Queue 1 item 11")
    if mega is not False and pathk_eligible(scene, config):
        step, group = mega_step(scene, config, device), GROUP
    else:
        step, group = scan_step(scene, config, device), 1
    group = min(group, preview_every or group, checkpoint_every or group)
    spp = sample_count if sample_count is not None else config.sample_count

    acc = torch.zeros((3, config.height, config.width, 4), dtype=torch.float32, device=device)
    start_spp = 0
    if resume and checkpoint_path and os.path.exists(_norm_ckpt_path(checkpoint_path)):
        acc, start_spp = load_checkpoint(checkpoint_path, config, device)
        if verbose:
            print(f"  resumed at sample {start_spp} from {checkpoint_path}")

    t0 = time.time()
    spp_done = last_preview = last_ckpt = start_spp
    at_boundary = True  # acc holds only whole steps
    try:
        while spp_done < spp:
            n = min(group, spp - spp_done)
            at_boundary = False
            step(acc, spp_done, n)
            spp_done += n
            at_boundary = True
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
        # a resume checkpoint is written only between two steps: a snapshot
        # inside one would count its finished part twice on resume
        # (render.cpp:285-301)
        if checkpoint_path and at_boundary:
            save_checkpoint(checkpoint_path, acc, spp_done, config)
        if verbose:
            print(f"  interrupted at sample {spp_done}/{spp} — partial film returned")

    if checkpoint_path and spp_done >= spp:
        save_checkpoint(checkpoint_path, acc, spp_done, config)
    out = _layers_out(acc)
    out["spp_done"] = spp_done
    return out
