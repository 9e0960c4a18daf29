"""One process of an N-process rehearsal of `parallel/multihost.py`.

Started N times, by `tests/test_torch_multihost.py`, `chip_smoke.py` or by
hand:

    python -m optix_renderer_tpu_torch.parallel.mh_worker \\
        --coordinator localhost:9876 --num-processes 2 --process-id 0 \\
        --local-devices 2 --device cpu --backend gloo --out /tmp/mh.npz

Each process joins the process group with `--local-devices` entries of
`--device` (CPU entries, or one card that the ranks share, both on gloo;
ranks on cards of their own take nccl), builds the global (tile × sample)
mesh, renders the Cornell box at 16×12, depth 3, 4 spp through
`render_multihost` (the scan path) and through `render_sharded` (the path
kernel over the global mesh's pixel ranges), takes one
`sharded_train_step` against a zero target, and, with `--scaling`, runs
`measure_scaling`. Rank 0 writes the layers (the kernel path's as
`kernel_<layer>`), the loss and the gradients to `--out` (.npz) and the
scaling JSON to `<out>.scaling.json` (the JAX worker's files,
mh_worker.py:30-37).
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=2,
                    help="entries of this rank's local mesh")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--backend", choices=["nccl", "gloo"], default="nccl")
    ap.add_argument("--out", default="")
    ap.add_argument("--scaling", action="store_true", help="also run measure_scaling")
    args = ap.parse_args()

    import numpy as np
    import torch
    import torch.distributed as dist

    from optix_renderer_tpu_torch.parallel.multihost import (
        init_distributed,
        make_multihost_mesh,
        measure_scaling,
        render_multihost,
    )
    from optix_renderer_tpu_torch.parallel.shard import render_sharded, sharded_train_step
    from optix_renderer_tpu_torch.scene.presets import make_cornell_box

    entries = init_distributed(args.coordinator, args.num_processes, args.process_id,
                               backend=args.backend, device=args.device,
                               local_devices=args.local_devices)
    rank = dist.get_rank()
    assert dist.get_world_size() == args.num_processes
    scene, config, _ = make_cornell_box(width=16, height=12, spp=4, integrator="path_mis",
                                        device=entries[0])
    config = dataclasses.replace(config, max_depth=3)

    mesh = make_multihost_mesh(devices=entries)
    print(f"[mh_worker {rank}] mesh {mesh.shape}, rendering", flush=True)
    out = render_multihost(scene, config, mesh, sample_count=4)
    kernel = render_sharded(scene, config, mesh, sample_count=4)
    print(f"[mh_worker {rank}] renders done", flush=True)

    target = torch.zeros((config.height, config.width, 3))
    ids = torch.arange(config.width * config.height)
    loss, grads = sharded_train_step(scene, config, mesh, target, ids, 0)
    grads = {k: g.cpu().numpy() for k, g in grads.items()}
    grad_finite = all(bool(np.isfinite(g).all()) for g in grads.values())
    print(f"[mh_worker {rank}] train step done", flush=True)

    scaling = measure_scaling(scene, config, spp=4, repeats=2, mesh=mesh) if args.scaling else None
    if args.out and rank == 0:
        np.savez(args.out, composite=out["composite"], albedo=out["albedo"],
                 normal=out["normal"], loss=np.float64(loss), grad_finite=np.bool_(grad_finite),
                 **{f"kernel_{k}": kernel[k] for k in ("composite", "albedo", "normal", "weights")},
                 n_devices=np.int64(mesh.size), n_processes=np.int64(dist.get_world_size()),
                 **{f"grad_{k}": g for k, g in grads.items()})
        if scaling is not None:
            with open(args.out + ".scaling.json", "w") as f:
                json.dump(scaling, f, indent=1)
    print(f"[mh_worker {rank}] ok: mesh={mesh.shape} loss={float(loss):.6g} "
          f"grads_finite={grad_finite}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
