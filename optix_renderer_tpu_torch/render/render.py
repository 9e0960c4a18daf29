"""Render entry point: `render()` dispatch, the scan path, film readout,
checkpoints.

Counterpart of `optix_renderer_tpu/render/render.py`, dispatched as the JAX
package dispatches (render.py:203-224), with no gate on the device: a scene
the path kernel takes (`pathk_eligible`: ≤ 8,192 triangles, ≤ 64 spheres,
a box / tent / gaussian filter) goes to `mega_render.mega_step`, whose
kernel has a small branch (≤ 64 triangles) and a medium branch (65–8,192);
every other scene, or any scene with `mega=False`, to the scan path below;
one sample loop drives either. The scan path renders one sample round at a
time over chunks of up to `MAX_LANES` pixels: camera rays, the
integrator's bounce loop (`integrators/`), whose intersections launch the
kernels of `csrc/isect.cu` on a CUDA device and run their plain torch
versions on the CPU, and the filter splat (`render/film.py`); on a CUDA
device the path integrators' round is captured once as a CUDA graph and
replayed, its bounces shading in `csrc/scan.cu` where the rule
`scan_graph.shade_scene`, asked once per render, allows. A CUDA device
without a GPU raises; nothing falls back.

Layer order matches ERenderLayer (integrator.h:29-39):
0 = composite, 1 = albedo, 2 = normal.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from optix_renderer_tpu_torch.integrators import get_integrator
from optix_renderer_tpu_torch.integrators import path as path_integrators
from optix_renderer_tpu_torch.ops import camera as camera_ops
from optix_renderer_tpu_torch.render import film
from optix_renderer_tpu_torch.render import sampler as smp
from optix_renderer_tpu_torch.render import scan_graph
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData
from optix_renderer_tpu_torch.utils import tracing
from optix_renderer_tpu_torch.utils.device import resolve_device

# Upper bound on rays in flight per chunk: at 2^19 lanes an 800×600 frame is
# one chunk per sample round, as in the JAX package (render.py:35).
MAX_LANES = 1 << 19


def preprocess(scene: SceneData, config: RenderConfig, device="cuda") -> SceneData:
    """The integrator's preprocess hook (`Integrator::preprocess`,
    render.cpp:272; render.py:38-53 of the JAX package): the photon mapper
    builds its photon map here, on `device`, once per render, from the
    integrator's `photonCount` (default 100,000) and `photonRadius` (0:
    the scene's bbox diagonal / 500), with max(emitters, 1) lights and the
    config's seed, and returns the scene on `device` with its map. A scene
    that already carries a map (one built by the JAX package and carried
    across by `scene_from_numpy`) keeps it."""
    if config.integrator == "photonmapper" and scene.photons.pos.shape[0] == 0:
        from optix_renderer_tpu_torch.ops.photon import build_photon_map

        scene = scene.to(device)
        pm = build_photon_map(
            scene,
            photon_count=int(config.iprop("photonCount", 100_000)),
            radius=float(config.iprop("photonRadius", 0.0)),
            max_depth=config.max_depth,
            n_lights=max(config.n_emitters, 1),
            seed=config.seed,
            device=device,
        )
        scene = dataclasses.replace(scene, photons=pm)
    return scene


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


def load_checkpoint(path: str, config: RenderConfig, device="cuda"):
    """Load (acc on `device`, spp_done); raises on resolution/seed mismatch."""
    device = resolve_device(device)
    with np.load(_norm_ckpt_path(path)) as z:
        wh = z["shape_key"]
        if (int(wh[0]), int(wh[1])) != (config.width, config.height):
            raise ValueError(f"checkpoint is {wh[0]}x{wh[1]}, render is "
                             f"{config.width}x{config.height}")
        if int(z["seed"]) != config.seed:
            raise ValueError("checkpoint seed differs — sample streams diverge")
        return torch.from_numpy(z["acc"]).to(device), int(z["spp_done"])


@tracing.traced("render.readout")
def _layers_out(acc) -> dict[str, np.ndarray]:
    """[3,H,W,4] accumulator → numpy layers. On the path-kernel path channel 3
    counts samples, so `weights` is the number of samples per pixel; on the
    scan path it sums filter weights. The division runs where the film lies
    (float32 division rounds alike in torch and numpy, so the layers are the
    host formula's bit for bit); a film on the card then comes to the host
    in one wait, its copies queued into pinned memory (the span
    `readout.wait`, where the request's device counters are folded too)."""
    a = acc.detach()
    w = a[..., 3:4]
    layers = torch.where(w > 1e-9, a[..., :3] / torch.clamp_min(w, 1e-9), 0.0)
    layers, weights = (x.to("cpu", non_blocking=True) for x in (layers, a[0, ..., 3]))
    with tracing.span("readout.wait"):
        if a.is_cuda:
            torch.cuda.synchronize(a.device)
        tracing.fold_device()
    layers = layers.numpy()
    return {
        "composite": layers[0],
        "albedo": layers[1],
        "normal": layers[2],
        "weights": weights.numpy(),
    }


def _round_layers(scene: SceneData, config: RenderConfig, pixel_ids, sample_idx, sc,
                  s2c=None):
    """One sample for a chunk of pixels → (pos [N,2], layers [3,N,3])
    (renderBlock, render.cpp:421-459: per-pixel jitter, camera ray, Li).
    `sample_idx` is an int, or an integer tensor of per-lane sample indices
    ([N]: the adaptive sampler's virtual indices; []: the captured round's
    scalar, `render/scan_graph.py`); either is taken modulo 2^32, as the
    JAX package's uint32 cast takes its int32. `s2c`: the camera's
    `sample_to_camera_matrix` on the pixels' device, made here when None.
    `sc`: the rule's answer (`scan_graph.shade_scene`), the kernel's tables
    (`path.li_path_fused`) or None (the integrator's torch chain)."""
    px = (pixel_ids % config.width).to(torch.float32)
    py = (pixel_ids // config.width).to(torch.float32)
    s = smp.make_sampler(pixel_ids, sample_idx, seed=config.seed)
    s, jitter = smp.next_2d(s)
    s, aperture = smp.next_2d(s)
    pos = torch.stack([px, py], dim=-1) + jitter
    ray, _ = camera_ops.sample_ray(scene.camera, config.width, config.height, pos, aperture,
                                   s2c=s2c)
    if sc is not None:
        L, albedo, normal, _ = path_integrators.li_path_fused(scene, config, ray, s, sc)
    else:
        L, albedo, normal, _ = get_integrator(config.integrator)(scene, config, ray, s)
    # a dead lane's NaN / Inf must not poison the film
    L = torch.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
    return pos, torch.stack([L, albedo, normal])


def render_round(scene: SceneData, config: RenderConfig, pixel_ids, sample_idx) -> torch.Tensor:
    """One sample round for `pixel_ids` [N] → a fresh [3,H,W,4] film (the
    JAX `render_round`, render.py:81-90). The scene and the ids lie on one
    device; the film is differentiable with respect to the scene's tensors
    (`parallel/shard.py: train_step`). The rule is asked here, once."""
    sc = scan_graph.shade_scene(scene, config, pixel_ids.device)
    pos, layers = _round_layers(scene, config, pixel_ids, sample_idx, sc)
    return film.splat(config.width, config.height, config.rfilter, pos, layers)


@tracing.traced("scan.round")
def render_round_accumulate(acc, scene: SceneData, config: RenderConfig, pixel_ids, sample_idx,
                            sc, s2c=None) -> None:
    """One sample round for `pixel_ids` [N] int64 (negative ids are padding
    lanes, outside the image), splatted into `acc` [3,H,W,4] in place, in
    chunks of up to `MAX_LANES` lanes; `sample_idx` (a per-lane one sliced
    with the ids), `sc` and `s2c` as in `_round_layers`. The film carries no
    gradient (`render_round` is the differentiable round), so a scene whose
    tensors require grad splats its layers detached."""
    per_lane = isinstance(sample_idx, torch.Tensor) and sample_idx.dim() > 0
    for c in range(0, pixel_ids.shape[0], MAX_LANES):
        si = sample_idx[c:c + MAX_LANES] if per_lane else sample_idx
        pos, layers = _round_layers(scene, config, pixel_ids[c:c + MAX_LANES], si, sc, s2c)
        with tracing.span("scan.splat"):
            film.splat_(acc, config.rfilter, pos, layers.detach())


def scan_step(scene: SceneData, config: RenderConfig, device: torch.device):
    """The scan path (render.py:246-302 of the JAX package) →
    `step(acc, spp0, n_spp)`, which renders sample rounds spp0 …
    spp0 + n_spp − 1 over the image's pixel ids, padded to whole chunks of
    `MAX_LANES`: on a CUDA device, for `scan_graph.GRAPH_INTEGRATORS` on a
    scene without gradients (`scan_graph.graphable`), by replaying the
    round captured as a CUDA graph (`scan_graph.graph_step`), else eagerly
    (`scan_graph.eager_step`); either asks the rule for the shading kernel
    (`scan_graph.shade_scene`) once."""
    get_integrator(config.integrator)  # an integrator not ported yet raises here
    scene = scene.to(device)
    w, h = config.width, config.height
    n_pix = w * h
    pad = -n_pix % min(MAX_LANES, n_pix)
    # padding lanes sit far outside the image, so their splat adds nothing
    ids = torch.cat([torch.arange(n_pix, dtype=torch.int64),
                     torch.full((pad,), -max(w, h) * 4, dtype=torch.int64)]).to(device)

    def rounds(acc, sample_idx, cfg: RenderConfig, sc, s2c) -> None:
        render_round_accumulate(acc, scene, cfg, ids, sample_idx, sc, s2c)

    if scan_graph.graphable(scene, config, ids.device):
        return scan_graph.graph_step(scene, config, ids, rounds)
    return scan_graph.eager_step(scene, config, ids, rounds)


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
      checkpoint when it came between two steps;
    - `wavefront=True` renders `path_mis` / `path_mats` by path
      regeneration (`render/wavefront.py`), even a scene the path kernel
      takes, with previews every 4k iterations for `preview_every=k`; any
      other integrator keeps the scan path. It has no checkpoints: a
      snapshot would lose the paths in flight, so `checkpoint_path` or
      `resume` with it raises.

    An adaptive config renders uniformly here, on the scan path (as the JAX
    `render()` does); `render/adaptive.py: render_adaptive` places its
    samples by variance. `preprocess` runs first, so a photon-mapper render
    builds its photon map inside this call.

    Both paths run the one loop below; each gives a `step(acc, spp0, n)`
    that adds n samples per pixel, and the samples one step may take
    (`mega_render.GROUP` for the path kernel, one sample round for the scan
    path, fewer when previews or checkpoints come more often).
    """
    from optix_renderer_tpu_torch.ops.cuda.pathk import pathk_eligible
    from optix_renderer_tpu_torch.render import wavefront as wf
    from optix_renderer_tpu_torch.render.mega_render import GROUP, mega_step

    device = resolve_device(device)
    if wavefront and config.integrator in wf.WAVEFRONT_INTEGRATORS:
        if checkpoint_path is not None or resume:
            raise ValueError("wavefront mode has no mid-render checkpoint; use wavefront=False "
                             "with checkpoint_path / resume")
        return wf.render_wavefront(
            scene, config, sample_count=sample_count, verbose=verbose,
            preview_every_iters=preview_every * 4 if preview_every else 0,
            preview_callback=preview_callback, device=device)
    spp = sample_count if sample_count is not None else config.sample_count
    with tracing.span("render", spp=spp, pixels=config.width * config.height) as root:
        with tracing.span("render.dispatch"):
            scene = preprocess(scene, config, device)
            if mega is not False and pathk_eligible(scene, config):
                step, group, path = mega_step(scene, config, device), GROUP, "pathk"
            else:
                step, group, path = scan_step(scene, config, device), 1, "scan"
            root.set(path=path)
            group = min(group, preview_every or group, checkpoint_every or group)

            acc = torch.zeros((3, config.height, config.width, 4), dtype=torch.float32,
                              device=device)
            start_spp = 0
            if resume and checkpoint_path and os.path.exists(_norm_ckpt_path(checkpoint_path)):
                acc, start_spp = load_checkpoint(checkpoint_path, config, device)
                if verbose:
                    print(f"  resumed at sample {start_spp} from {checkpoint_path}")
        spp_done = sample_loop(acc, step, group, spp, start_spp, config, verbose=verbose,
                               preview_every=preview_every, preview_callback=preview_callback,
                               checkpoint_path=checkpoint_path,
                               checkpoint_every=checkpoint_every)
        out = _layers_out(acc)
    out["spp_done"] = spp_done
    return out


def sample_loop(acc, step, group: int, spp: int, start_spp: int, config: RenderConfig, *,
                verbose: bool = False, preview_every: int = 0, preview_callback=None,
                checkpoint_path: str | None = None, checkpoint_every: int = 0) -> int:
    """The render loop of `render()` and `parallel/shard.py: render_sharded`:
    `step(acc, spp0, n)` adds samples spp0 … spp0 + n − 1 into `acc` in
    place, at most `group` at a time, from `start_spp` until `spp` are done;
    previews and checkpoints come after the step that passes their period
    (in samples). SIGINT returns early, writing the checkpoint only between
    two steps: a snapshot inside one would count its finished part twice on
    resume (render.cpp:285-301). Returns the samples done."""
    t0 = time.time()
    spp_done = last_preview = last_ckpt = start_spp
    at_boundary = True  # acc holds only whole steps
    try:
        while spp_done < spp:
            n = min(group, spp - spp_done)
            at_boundary = False
            with tracing.span("render.step", sample=spp_done, n=n):
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
        if checkpoint_path and at_boundary:
            save_checkpoint(checkpoint_path, acc, spp_done, config)
        if verbose:
            print(f"  interrupted at sample {spp_done}/{spp} — partial film returned")

    if checkpoint_path and spp_done >= spp:
        save_checkpoint(checkpoint_path, acc, spp_done, config)
    return spp_done
