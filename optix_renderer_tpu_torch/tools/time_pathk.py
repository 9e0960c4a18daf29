"""Device time of the path kernel on its two cells, and the Cornell
render's wall clock (needs a CUDA GPU):

    python3 optix_renderer_tpu_torch/tools/time_pathk.py [--root DIR] [--reps N]

Times one 800x600 x 16-spp launch of `pathk_trace` on the Cornell box (12
triangles, the small branch) and on config M (the tessellated Cornell box
at nu=40, nv=51, 8,012 triangles, the medium branch), path_mis, depth 16,
gaussian filter: CUDA events around each launch, the mean, the median and
every launch of `reps` after one warm-up. Then the Cornell cell end to
end: `render()` at 512 spp (the `bench.py` headline) with the film on the
host, `reps` times after a 16-spp warm-up, on the host's clock. `--root`
imports the package from another checkout (for instance a parent commit
unpacked with `git archive`), so that two versions can be timed in one
run on one card.

Beside each cell's times it prints the share of lane iterations that do
work, from the launch's per-pixel iteration counts (row 10): for warps of
32 fixed pixels (a row of 32, or a 2x16, 4x8 or 8x4 tile) and blocks of
128 (`lane_efficiency`; a fixed grid of one thread per pixel), and, for
the persistent grid of a checkout whose launcher reports it, lanes that
refill (`refill_efficiency`, a model of the small branch's kernel).
Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import heapq
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def lane_efficiency(iters, group: int) -> float:
    """Share of lane-iterations that do work when each `group` consecutive
    pixels run in lockstep until the slowest of them ends (a warp of 32, or
    a block of 128 that holds its slots until its slowest warp ends):
    sum(iters) / sum over groups of group * max(iters in the group). The
    last group is filled up with idle lanes."""
    it = np.asarray(iters, dtype=np.float64).ravel()
    g = np.concatenate([it, np.zeros((-it.size) % group)]).reshape(-1, group)
    return float(it.sum() / (group * g.max(axis=1)).sum())


def tile_order(iters, width: int, th: int, tw: int) -> np.ndarray:
    """Per-pixel values of a row-major image `width` wide, reordered so
    that each run of th * tw consecutive values is one th x tw tile (the
    image's sides must be multiples of the tile's): `lane_efficiency` of
    the result with group th * tw is that of warps laid out as tiles."""
    img = np.asarray(iters).reshape(-1, width)
    h = img.shape[0]
    return img.reshape(h // th, th, width // tw, tw).transpose(0, 2, 1, 3).ravel()


def refill_efficiency(iters, n_warps: int, warp: int = 32) -> float:
    """The same share for lanes that refill: `n_warps` warps of `warp` lanes
    make one pass per step, all at the same rate; a lane whose pixel is done
    takes the next pixel (in pixel order) from a shared counter at its next
    pass, and a warp ends when no pixel is left and its last lane is done.
    Returns sum(iters) / (warp * sum of the warps' passes)."""
    it = np.asarray(iters, dtype=np.int64).ravel()
    lanes = [(0, k) for k in range(n_warps * warp)]
    ends = np.zeros(n_warps * warp, dtype=np.int64)
    for n in it:
        t, k = lanes[0]
        ends[k] = t + n
        heapq.heapreplace(lanes, (t + n, k))
    passes = ends.reshape(n_warps, warp).max(axis=1).sum()
    return float(it.sum() / (warp * passes))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose optix_renderer_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_pathk needs a CUDA GPU (torch.cuda.is_available() is False)")
    from optix_renderer_tpu_torch.ops.cuda import pathk
    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.scene.presets import make_cornell_box, make_tessellated_cornell

    if not Path(pathk.__file__).resolve().is_relative_to(Path(args.root).resolve()):
        raise SystemExit(f"imported {pathk.__file__}, not the package under {args.root}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    # scenes on the card where the presets take a device (an older checkout
    # builds them on the host)
    kw = {"device": dev} if "device" in inspect.signature(make_cornell_box).parameters else {}
    cells = {"cornell": make_cornell_box(800, 600, 16, "path_mis", **kw)[:2],
             "config_m": make_tessellated_cornell(800, 600, 16, "path_mis", nu=40, nv=51,
                                                   **kw)[:2]}
    res = {"root": args.root, "gpu": smi}
    for name, (scene, cfg) in cells.items():
        cfg = dataclasses.replace(cfg, max_depth=16, rfilter="gaussian")
        tables, meta = pathk.build_pathk_tables(scene, cfg, dev)
        run = lambda: pathk.pathk_trace(tables, meta, cfg, n_pix=800 * 600, spp0=0, n_spp=16)
        out = run()  # warm-up (and the library's build)
        ms = []
        for _ in range(args.reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            run()
            ev[1].record()
            torch.cuda.synchronize()
            ms.append(ev[0].elapsed_time(ev[1]))
        iters = out[10].cpu().numpy()
        res[name] = {"t_cnt": meta["t_cnt"], "ms": sum(ms) / len(ms),
                     "ms_median": float(np.median(ms)), "ms_each": ms,
                     "iterations": float(iters.astype(np.float64).sum()),
                     "lane_eff_warp32": lane_efficiency(iters, 32),
                     "lane_eff_block128": lane_efficiency(iters, 128),
                     "lane_eff_warp_tiles": {f"{th}x{32 // th}": lane_efficiency(
                         tile_order(iters, cfg.width, th, 32 // th), 32) for th in (2, 4, 8)}}
        # a checkout whose launcher reports its grid (persistent blocks) also
        # gets, for the small branch, the refill model at that grid's lanes
        if hasattr(pathk, "last_launch"):
            launch = res[name]["launch"] = pathk.last_launch()
            if not launch["medium"]:
                res[name]["lane_eff_refill_model"] = refill_efficiency(
                    iters, launch["blocks"] * launch["threads"] // 32)
    scene, cfg = cells["cornell"]
    cfg = dataclasses.replace(cfg, max_depth=16, rfilter="gaussian")
    render(scene, cfg, sample_count=16, device=dev)  # warm-up
    walls = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render(scene, cfg, sample_count=512, device=dev)  # returns the film on the host
        walls.append(time.perf_counter() - t0)
    res["cornell_render_512spp"] = {"s_each": walls, "s_median": float(np.median(walls)),
                                    "mpaths_median": 800 * 600 * 512 / float(np.median(walls))
                                    / 1e6}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
