"""Seconds and peak memory of `parallel/shard.py: train_step` (needs a CUDA GPU):

    python3 optix_renderer_tpu_torch/tools/time_train_step.py [--root DIR] [--reps N]

The Cornell box at 800x600, `path_mis`, depth 16, 1 spp: one 480,000-lane
`render_round` and its backward, against the same render at radiance x
0.8, as `chip_smoke.py` phase 20 takes it. After one warm-up step, `reps`
times each: the forward (the loss with its graph), the backward
(`torch.autograd.grad` over the four parameters) and the entry point
(`train_step`, both together), each with the device synchronized on both
sides; their medians and each of them, and the peak memory of one step.
`--root` imports the package from another checkout (for instance a
parent commit unpacked with `git archive`), so that two versions can be
timed in one run on one card:

    for r in .ab/parent . . .ab/parent; do
        python3 optix_renderer_tpu_torch/tools/time_train_step.py --root $r; done

Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose optix_renderer_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    import torch

    from optix_renderer_tpu_torch.parallel import shard
    from optix_renderer_tpu_torch.render import film
    from optix_renderer_tpu_torch.render.render import render_round
    from optix_renderer_tpu_torch.scene.presets import make_cornell_box

    if not Path(shard.__file__).resolve().is_relative_to(Path(args.root).resolve()):
        raise SystemExit(f"imported {shard.__file__}, not the package under {args.root}")
    dev = torch.device("cuda")
    scene, cfg, _ = make_cornell_box(800, 600, 1, "path_mis", device=dev)
    cfg = dataclasses.replace(cfg, max_depth=16)
    scene = scene.to(dev)
    ids = torch.arange(cfg.width * cfg.height, device=dev)
    em = scene.emitters.radiance
    with torch.no_grad():
        dim = dataclasses.replace(scene, emitters=dataclasses.replace(scene.emitters,
                                                                      radiance=em * 0.8))
        target = film.to_bitmap(render_round(dim, cfg, ids, 0))[0]

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    def forward(leaves):
        img = render_round(shard.apply_params(scene, leaves), cfg, ids, 0)
        return torch.mean((film.to_bitmap(img)[0] - target) ** 2)

    shard.train_step(scene, cfg, target, ids, 0, device=dev)  # warm-up
    times = {"forward_s": [], "backward_s": [], "step_s": []}
    for _ in range(args.reps):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in shard.trainable_params(scene).items()}
        loss, f_s = synced(lambda: forward(leaves))
        _, b_s = synced(lambda: torch.autograd.grad(loss, list(leaves.values()),
                                                    allow_unused=True))
        del loss
        torch.cuda.reset_peak_memory_stats(dev)
        _, s_s = synced(lambda: shard.train_step(scene, cfg, target, ids, 0, device=dev))
        for k, v in zip(times, (f_s, b_s, s_s)):
            times[k].append(v)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    res = {"root": args.root, "gpu": smi, "reps": args.reps,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           **{k[:-2] + "_median_s": sorted(v)[len(v) // 2] for k, v in times.items()},
           **times}
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
