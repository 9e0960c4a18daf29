"""Device time of the path kernel on its two cells (needs a CUDA GPU):

    python3 optix_renderer_tpu_torch/tools/time_pathk.py [--root DIR] [--reps N]

Times one 800x600 x 16-spp launch of `pathk_trace` on the Cornell box (12
triangles, the small branch) and on config M (the tessellated Cornell box
at nu=40, nv=51, 8,012 triangles, the medium branch), path_mis, depth 16,
gaussian filter: CUDA events around each launch, the mean and every
launch of `reps` after one warm-up. `--root` imports the package from
another checkout (for instance a parent commit unpacked with
`git archive`), so that two versions of the kernel can be timed in one run
on one card. Prints one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path


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
    from optix_renderer_tpu_torch.scene.presets import make_cornell_box, make_tessellated_cornell

    if not Path(pathk.__file__).resolve().is_relative_to(Path(args.root).resolve()):
        raise SystemExit(f"imported {pathk.__file__}, not the package under {args.root}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cells = {"cornell": make_cornell_box(800, 600, 16, "path_mis")[:2],
             "config_m": make_tessellated_cornell(800, 600, 16, "path_mis", nu=40, nv=51)[:2]}
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
        res[name] = {"t_cnt": meta["t_cnt"], "ms": sum(ms) / len(ms), "ms_each": ms,
                     "iterations": float(out[10].double().sum())}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
