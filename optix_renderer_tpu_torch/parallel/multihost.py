"""Multi-process rendering on `torch.distributed`.

Counterpart of `optix_renderer_tpu/parallel/multihost.py`. Every process
runs the same code: `init_distributed` joins the process group, and one
global (tile × sample) mesh spans all ranks. The tile axis spans ranks
(each rank owns a contiguous slab of lanes and talks to no other rank
during a round) and the sample axis stays inside a rank. The only
collective of a render is one `all_reduce(SUM)` of the film per round (the
reference's mutex-guarded ImageBlock merge, block.cpp:125).

Lanes are seeded by (pixel, sample) alone, so the film does not depend on
the number of ranks or the mesh's layout, up to the float order of the
sums.

The JAX module stages its inputs as global arrays (`stage_global`,
`stage_replicated_tree`). Nothing here needs that: every rank builds the
same scene from the same file (or preset) and moves it to its own devices,
and a rank's lane ids are a slice of the same padded range
(`shard.tile_slabs`).

Backends, named by the caller and printed, never chosen silently:
* `gloo` — CPU ranks (the hardware-free rehearsal, `mh_worker.py`), and
  ranks that share one card, which NCCL refuses: CUDA films then go
  through a host copy for each collective (`shard.all_reduce_`);
* `nccl` — ranks on cards of their own, the collectives on the cards.

Usage (the same command on every host, or `torchrun`, whose environment
`init_distributed` reads when no coordinator is given):

    python -m optix_renderer_tpu_torch render scene.xml --distributed \\
        --coordinator HOST0:9876 --num-processes 4 --process-id $RANK --backend nccl
"""

from __future__ import annotations

import json
import time

import torch
import torch.distributed as dist

from optix_renderer_tpu_torch.parallel.shard import (
    DeviceMesh,
    _most_square,
    _rank,
    render_sharded,
    sharded_step,
)
from optix_renderer_tpu_torch.render.render import preprocess, resolve_device
from optix_renderer_tpu_torch.scene.data import RenderConfig, SceneData


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, *, backend: str = "nccl",
                     device="cuda", local_devices: int | None = None) -> list[torch.device]:
    """Join the process group and return this rank's mesh entries.

    With `coordinator` ("host:port"), `num_processes` and `process_id` the
    group meets at `tcp://coordinator`; without them it reads the `env://`
    variables that `torchrun` sets (MASTER_ADDR, MASTER_PORT, RANK,
    WORLD_SIZE), as the JAX package defers to its auto-detection. The
    rank's device is `device`, for CUDA card `rank % device_count`;
    `local_devices` entries of it (default 1) make its local mesh (pass
    them to `make_multihost_mesh`). A CUDA device without a GPU raises.
    """
    dev = resolve_device(device)
    if coordinator is None and num_processes is None:
        dist.init_process_group(backend=backend, init_method="env://")
    else:
        dist.init_process_group(backend=backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    entries = [dev] * (local_devices or 1)
    print(f"[rank {dist.get_rank()}/{dist.get_world_size()}] torch.distributed backend="
          f"{backend}, {len(entries)} mesh entries on {dev}", flush=True)
    return entries


def make_multihost_mesh(sample_axis: int | None = None, devices=None) -> DeviceMesh:
    """The global (tile, sample) mesh, this rank's entries in it
    (multihost.py:88-112): the rank's `devices` (those `init_distributed`
    returns; by default the rank's card, `rank % device_count`, or every
    visible card without a process group) split into local tiles ×
    `sample_axis` (default the most square split, tile ≥ sample); rank r
    owns global tiles r·local … r·local + local − 1."""
    if devices is None:
        resolve_device("cuda")
        n = torch.cuda.device_count()
        devices = ([torch.device("cuda", _rank() % n)] if dist.is_initialized() else
                   [torch.device("cuda", i) for i in range(n)])
    devices = [resolve_device(d) for d in devices]
    sample = sample_axis or _most_square(len(devices))
    local = len(devices) // sample
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    return DeviceMesh(tuple(tuple(devices[t * sample:(t + 1) * sample]) for t in range(local)),
                      tile0=rank * local, n_tile=world * local, world=world)


def render_multihost(scene: SceneData, config: RenderConfig, mesh: DeviceMesh | None = None,
                     sample_count: int | None = None, verbose: bool = False,
                     **options) -> dict:
    """`render_sharded`'s scan path (`mega=False`, as the JAX module renders)
    over the global mesh (default `make_multihost_mesh()`): each rank
    renders its tiles' slabs, then one all-reduce of the film per round.
    Every rank returns the same layers and `spp_done` (the samples rounded
    up to the sample axis). `options` are `render_sharded`'s previews,
    checkpoints and resume; only rank 0 writes them."""
    mesh = mesh if mesh is not None else make_multihost_mesh()
    return render_sharded(scene, config, mesh, sample_count, verbose=verbose, mega=False,
                          **options)


def measure_scaling(scene: SceneData, config: RenderConfig, spp: int = 4, repeats: int = 3,
                    out_path: str | None = None, mesh: DeviceMesh | None = None) -> dict:
    """Paths/s of `render_sharded`'s scan-path step on one device against
    the whole mesh (default `make_multihost_mesh()`), multihost.py:187-259:
    efficiency = full-mesh paths/s / (one-device paths/s × devices). Every
    rank times its own one-device baseline at once; rank 0 writes the JSON
    to `out_path`. With one device the two runs are one, and the efficiency
    is 1 by construction."""
    full = mesh if mesh is not None else make_multihost_mesh()
    scene = preprocess(scene, config, full.first)
    n_pix = config.width * config.height

    def bench(m: DeviceMesh) -> float:
        step = sharded_step(scene, config, m, kernel=False)
        n_rounds = max(1, spp // m.shape[1])

        def run():
            acc = torch.zeros((3, config.height, config.width, 4), dtype=torch.float32,
                              device=m.first)
            step(acc, 0, n_rounds * m.shape[1])
            if acc.is_cuda:
                torch.cuda.synchronize(acc.device)

        run()  # warm-up
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return n_pix * n_rounds * m.shape[1] / best

    paths_1 = bench(DeviceMesh(((full.first,),)))
    n_dev = full.size
    paths_n = bench(full) if n_dev > 1 else paths_1
    res = {
        "n_devices": int(n_dev),
        "n_processes": int(full.world),
        "paths_per_s_1dev": float(paths_1),
        "paths_per_s_full": float(paths_n),
        "scaling_efficiency": float(paths_n / (paths_1 * n_dev)),
        "config": {"width": config.width, "height": config.height, "spp": spp,
                   "integrator": config.integrator},
    }
    if out_path and _rank() == 0:
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    return res
