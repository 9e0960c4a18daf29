"""Multiple devices: a (tile × sample) mesh of torch devices, the sharded
render, and gradients of an image loss with respect to the scene's
parameters.

Counterpart of `optix_renderer_tpu/parallel/shard.py`. The JAX package runs
one `shard_map` program over a `jax.sharding.Mesh`; here a `DeviceMesh` is a
grid of `torch.device`s that only partitions the work, and each entry's
share runs eagerly on its device:

* `make_mesh` factors the devices as the JAX `make_mesh` does (shard.py:
  33-52): the most square grid with tile ≥ sample. An entry may repeat (the
  tests' CPU entries, or one card entered several times), and each distinct
  device gets the scene once.
* `render_sharded` (shard.py:228-351). A scene the path kernel takes runs
  it on every entry: the pixels split into contiguous ranges over the
  flattened mesh, one `pathk_trace` per entry and group of samples with its
  first pixel (the JAX kernel's `base_block`), the rows added into one
  accumulator on the mesh's first device (`mega_render._pathk_group`). Any
  other scene takes the scan path: each tile renders its slab of lane ids
  for sample `base + s` on entry (tile, s), in chunks of `MAX_LANES`
  (`render.render_round_accumulate`), into a film of its own; the films
  are summed on the first device (the JAX `psum`). On a multi-process
  mesh (`parallel/multihost.py`) a rank's entries take their ranges or
  slabs of the global mesh and each group's film is all-reduced, so every
  rank holds the whole image. Lanes are seeded by (pixel, sample) alone,
  so the layout never changes a lane; on the kernel path the film equals
  `render()`'s bit for bit, on the scan path the sum's order moves it by
  float rounding.
* `sharded_train_step` (shard.py:377-411): each tile renders its lanes
  through `render_round` on its device; the films are summed on the first
  device before `to_bitmap` and the loss, so the gradients are the whole
  image's. Across processes (`parallel/multihost.py`) the detached film is
  all-reduced, the loss's gradient with respect to that sum is taken on
  every rank and sent back into the rank's own partial film, and the
  parameter gradients are all-reduced once.
* `trainable_params` / `apply_params` name the four parameter tables
  (texture values, diffuse `kd`, microfacet `alpha`, emitter radiance) and
  `train_step` is the one-device step: one `render_round` of the scan path,
  `to_bitmap`, the mean squared error against a target, and its gradients
  by autograd.

The forward launches the port's kernels on detached inputs and replays
their discrete choices in torch (`ops/intersect.py`, `ops/volume_grid.py`),
so the backward runs torch only. Derived tables (the emitter pick, the
envmap tables, the path kernel's packing) stay as built, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from optix_renderer_tpu_torch.render import film, scan_graph
from optix_renderer_tpu_torch.render.render import (
    _layers_out,
    _norm_ckpt_path,
    load_checkpoint,
    preprocess,
    render_round,
    render_round_accumulate,
    resolve_device,
    sample_loop,
)
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData
from optix_renderer_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A (tile, sample) grid of torch devices (the JAX `Mesh` with axes
    "tile" and "sample"). Entries may repeat.

    In a multi-process mesh (`parallel/multihost.py: make_multihost_mesh`)
    `devices` holds this process's entries only, tiles `tile0 …
    tile0 + len(devices) − 1` of `n_tile` across `world` processes; a
    one-process mesh has tile0 0, n_tile its own rows and world 1."""

    devices: tuple  # [tiles][sample] torch.device
    tile0: int = 0
    n_tile: int = 0  # tiles over all processes; 0: len(devices)
    world: int = 1

    def __post_init__(self):
        rows = tuple(tuple(torch.device(d) for d in row) for row in self.devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0]) for r in rows):
            raise ValueError("a mesh is a non-empty grid of devices")
        object.__setattr__(self, "devices", rows)
        if self.n_tile == 0:
            object.__setattr__(self, "n_tile", len(rows))

    @property
    def shape(self) -> tuple[int, int]:
        """(tiles, samples) over all processes."""
        return self.n_tile, len(self.devices[0])

    @property
    def size(self) -> int:
        return self.n_tile * len(self.devices[0])

    @property
    def first(self) -> torch.device:
        return self.devices[0][0]

    @property
    def flat(self) -> list[torch.device]:
        """This process's entries, tile-major (the flattened mesh)."""
        return [d for row in self.devices for d in row]

    @property
    def distinct(self) -> list[torch.device]:
        return list(dict.fromkeys(self.flat))


def _most_square(n: int) -> int:
    """The largest factor of n that is at most √n (shard.py:44-48)."""
    return next(c for c in range(math.isqrt(n), 0, -1) if n % c == 0)


def make_mesh(n_devices: int | None = None, devices=None) -> DeviceMesh:
    """A (tile, sample) mesh of `devices` (default: every visible CUDA card,
    the first `n_devices` of them), factored as the most square grid with
    tile ≥ sample: 8 entries give (4, 2). A CUDA device without a GPU
    raises."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    devices = [resolve_device(d) for d in devices]
    sample = _most_square(len(devices))
    return DeviceMesh(tuple(tuple(devices[t * sample:(t + 1) * sample])
                            for t in range(len(devices) // sample)))


def all_reduce_(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Sum `t` over the mesh's processes in place (nothing on a one-process
    mesh) and return it. Under gloo a CUDA tensor goes through a host copy
    (`.cpu()`, all-reduce, copy back): gloo reduces host memory, and it is
    the backend of ranks that share one card, which NCCL refuses. Under
    NCCL the tensor stays on the card."""
    if mesh.world == 1:
        return t
    import torch.distributed as dist

    if t.is_cuda and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def tile_slabs(config: RenderConfig, mesh: DeviceMesh, pixel_ids=None) -> list[torch.Tensor]:
    """This process's tiles' lane ids (int64, on the CPU): `pixel_ids` (by
    default every pixel) padded to a multiple of the mesh's tiles with the
    scan path's off-image id (`render.scan_step`), cut into contiguous
    slabs, one per tile (the JAX `P("tile")` sharding)."""
    w, h = config.width, config.height
    ids = torch.arange(w * h) if pixel_ids is None else pixel_ids.detach().cpu().long()
    pad = (-ids.numel()) % mesh.n_tile
    ids = torch.cat([ids, torch.full((pad,), -max(w, h) * 4, dtype=torch.int64)])
    slab = ids.numel() // mesh.n_tile
    return [ids[(mesh.tile0 + t) * slab:(mesh.tile0 + t + 1) * slab]
            for t in range(len(mesh.devices))]


def _scenes(scene: SceneData, mesh: DeviceMesh) -> dict:
    """The scene on each distinct device of the mesh, moved once."""
    return {d: scene.to(d) for d in mesh.distinct}


def scan_round(scenes: dict, config: RenderConfig, mesh: DeviceMesh, slabs, sample_base: int):
    """One sample round of the scan path over this process's entries: entry
    (tile t, sample s) splats its tile's slab for sample `sample_base + s`
    (`render.render_round_accumulate`, in chunks of up to `MAX_LANES`) into
    a film of its own on its device; returns their sum on the mesh's first
    device, [3,H,W,4]. `scenes` maps each device to its (scene, `sc`), the
    rule's answer for it (`scan_graph.shade_scene`)."""
    shape = (3, config.height, config.width, 4)
    films = []
    for t, row in enumerate(mesh.devices):
        for s, dev in enumerate(row):
            img = torch.zeros(shape, dtype=torch.float32, device=dev)
            scene, sc = scenes[dev]
            render_round_accumulate(img, scene, config, slabs[t].to(dev), sample_base + s, sc)
            films.append(img)
    total = films[0].to(mesh.first, copy=True)
    for img in films[1:]:
        total += img.to(mesh.first)
    return total


def pixel_ranges(n_pix: int, n: int) -> list[tuple[int, int]]:
    """(pix0, n_pix) of each of n entries: contiguous ranges of ⌈n_pix / n⌉
    pixels, the last one shorter (the JAX kernel's block ranges,
    shard.py:135-138, at one-pixel granularity)."""
    per = -(-n_pix // n)
    return [(p, min(per, n_pix - p)) for p in range(0, n_pix, per)]


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def sharded_step(scene: SceneData, config: RenderConfig, mesh: DeviceMesh, kernel: bool):
    """`render_sharded`'s step → `step(acc, spp0, n)`, which adds samples
    spp0 … spp0 + n − 1 of the whole image into `acc` (on the mesh's first
    device) on every rank of the mesh.

    `kernel`: this process's entries trace their pixel ranges of the global
    mesh (entry i of rank r takes range r·local + i) into a film of the
    group, which is all-reduced over the ranks and added into `acc`; ranges
    are disjoint, so the sum only adds zeros. Otherwise the scan path
    (`scan_round`), one round of one sample per sample-axis entry, each
    round's film all-reduced; n must then be a multiple of the sample axis."""
    from optix_renderer_tpu_torch.ops.cuda import pathk
    from optix_renderer_tpu_torch.render.mega_render import _pathk_group

    if kernel:
        tables = {d: pathk.build_pathk_tables(scene, config, d) for d in mesh.distinct}
        local = mesh.tile0 * mesh.shape[1]
        ranges = pixel_ranges(config.width * config.height, mesh.size)
        mine = list(zip(mesh.flat, ranges[local:local + len(mesh.flat)]))

        def step(acc, spp0: int, n: int) -> None:
            part = torch.zeros_like(acc)
            for dev, (pix0, n_pix) in mine:
                _pathk_group(part, *tables[dev], config, spp0, n, pix0, n_pix)
            acc += all_reduce_(part, mesh)

        return step
    # each device's scene and the rule's answer for it, asked once
    scenes = {d: (s, scan_graph.shade_scene(s, config, d))
              for d, s in _scenes(scene, mesh).items()}
    slabs = tile_slabs(config, mesh)
    n_sample = mesh.shape[1]

    def step(acc, spp0: int, n: int) -> None:
        for base in range(spp0, spp0 + n, n_sample):
            acc += all_reduce_(scan_round(scenes, config, mesh, slabs, base), mesh)

    return step


@tracing.traced("render")
def render_sharded(
    scene: SceneData,
    config: RenderConfig,
    mesh: DeviceMesh | None = None,
    sample_count: int | None = None,
    *,
    verbose: bool = False,
    preview_every: int = 0,
    preview_callback=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    mega: bool | None = None,
) -> dict:
    """Render over every entry of `mesh` (default `make_mesh()`, which raises
    without a GPU); returns `render()`'s numpy layers and `spp_done`.

    `preprocess` runs first, on the first device. A scene the path kernel
    takes (`pathk_eligible`), unless `mega=False` or the config is
    adaptive, runs the kernel over pixel ranges (module docstring) in
    groups of `mega_render.GROUP` samples. Any other scene takes the scan
    path in rounds of one sample per sample-axis entry, so `spp_done`
    advances by the sample axis and is rounded up to it; a checkpoint whose
    sample count is not a multiple of the sample axis raises `ValueError`
    (it would render samples twice). Previews and checkpoints come every
    `preview_every` / `checkpoint_every` samples, and SIGINT returns the
    partial film, as in `render()`. On a multi-process mesh
    (`multihost.make_multihost_mesh`) every group's film is all-reduced, so
    every rank returns the whole image; every rank reads the checkpoint to
    resume, and only rank 0 writes checkpoints and previews.
    """
    from optix_renderer_tpu_torch.ops.cuda import pathk
    from optix_renderer_tpu_torch.render.mega_render import GROUP

    with tracing.span("render.dispatch"):
        mesh = mesh if mesh is not None else make_mesh()
        first = mesh.first
        scene = preprocess(scene, config, first)
        spp = sample_count if sample_count is not None else config.sample_count
        n_sample = mesh.shape[1]
        kernel = mega is not False and not config.adaptive and pathk.pathk_eligible(scene, config)

        acc = torch.zeros((3, config.height, config.width, 4), dtype=torch.float32, device=first)
        start_spp = 0
        if resume and checkpoint_path and os.path.exists(_norm_ckpt_path(checkpoint_path)):
            acc, start_spp = load_checkpoint(checkpoint_path, config, first)
            if not kernel and start_spp % n_sample:
                raise ValueError(
                    f"checkpoint holds {start_spp} samples, which is not a multiple of this mesh's "
                    f"sample axis ({n_sample}): resume with the original device layout or finish "
                    "the render on one device")
            if verbose:
                print(f"  resumed at sample {start_spp} from {checkpoint_path}")

        step = sharded_step(scene, config, mesh, kernel)
        if kernel:
            group = min(GROUP, preview_every or GROUP, checkpoint_every or GROUP)
        else:
            group = n_sample
            spp = -(-spp // n_sample) * n_sample
    writes = mesh.world == 1 or _rank() == 0
    spp_done = sample_loop(acc, step, group, spp, start_spp, config, verbose=verbose and writes,
                           preview_every=preview_every,
                           preview_callback=preview_callback if writes else None,
                           checkpoint_path=checkpoint_path if writes else None,
                           checkpoint_every=checkpoint_every)
    out = _layers_out(acc)
    out["spp_done"] = spp_done
    return out


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


def _grads(params: dict, grads) -> dict[str, torch.Tensor]:
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}


def train_step(scene: SceneData, config: RenderConfig, target: torch.Tensor, pixel_ids,
               sample_base, device="cuda") -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, grads) of mean((to_bitmap(render_round(...))[0] − target)²)
    with respect to `trainable_params(scene)`, for the lanes `pixel_ids` [N]
    (negative ids are padding) at sample `sample_base` (an int, or an [N]
    tensor of per-lane samples). The scene's tables are the parameters'
    current values; a parameter the loss does not reach gets a zero
    gradient."""
    device = resolve_device(device)
    scene = scene.to(device)
    params = {k: v.detach().requires_grad_(True) for k, v in trainable_params(scene).items()}
    if isinstance(sample_base, torch.Tensor):
        sample_base = sample_base.to(device)
    img = render_round(apply_params(scene, params), config, pixel_ids.to(device), sample_base)
    loss = torch.mean((film.to_bitmap(img)[0] - target.to(device)) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return loss.detach(), _grads(params, grads)


def sharded_train_step(scene: SceneData, config: RenderConfig, mesh: DeviceMesh,
                       target: torch.Tensor, pixel_ids, sample_base: int
                       ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """(loss, grads) as `train_step`, with the lanes `pixel_ids` [N] split
    into slabs over the mesh's tiles and entry (tile, s) rendering its slab
    at sample `sample_base + s` through `render_round` on its device. The
    films are summed on the mesh's first device before `to_bitmap`, so the
    gradients are the whole image's; on a multi-process mesh the summed
    film and the gradients are all-reduced (module docstring), and every
    rank returns the same loss and gradients, on its first device."""
    first = mesh.first
    base = {k: v.detach().to(first).requires_grad_(True)
            for k, v in trainable_params(scene).items()}
    slabs = tile_slabs(config, mesh, pixel_ids)
    scenes = {d: apply_params(scene.to(d), {k: p.to(d) for k, p in base.items()})
              for d in mesh.distinct}
    partial = None
    for t, row in enumerate(mesh.devices):
        for s, dev in enumerate(row):
            img = render_round(scenes[dev], config, slabs[t].to(dev), sample_base + s).to(first)
            partial = img if partial is None else partial + img
    # the loss's gradient with respect to the whole film, then back into
    # this process's share of it
    whole = all_reduce_(partial.detach().clone(), mesh).requires_grad_(True)
    loss = torch.mean((film.to_bitmap(whole)[0] - target.to(first)) ** 2)
    (g_film,) = torch.autograd.grad(loss, whole)
    grads = _grads(base, torch.autograd.grad(partial, list(base.values()), g_film,
                                             allow_unused=True))
    for g in grads.values():
        all_reduce_(g, mesh)
    return loss.detach(), grads
