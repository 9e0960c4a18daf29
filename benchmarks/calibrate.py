"""Readings that a cell's check limit is set from, on the card.

    python benchmarks/calibrate.py --workload <name> --seeds 12 [--control-seeds 3]

Sets the cell up once, then for each seed renders the requests the check
would sample (`check.renders` of the cell's own shape, render seeds drawn
from the seed as a run draws them) through the program and compares them
with the plain reference in float32 (the sound reading) and, for the
first `--control-seeds`, with the reference computed in bfloat16 (the
control: the nearest precision below the float32 the renderer states).
Prints one JSON line per reading. The benchmark's runs never run this.
"""

import argparse
import dataclasses
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--first-seed", type=int, default=1_000_003)
    p.add_argument("--control-seeds", type=int, default=3)
    args = p.parse_args()
    import torch

    from harness import guard, manifest
    from harness.cell import base_seed
    from harness.check import judge
    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.scene.build import load_scene

    cell = manifest.load_cell(args.workload)
    guard.require_cards(cell.chips)
    cfg, spp = cell.config, int(cell.traffic["spp"])
    tmp = Path(tempfile.mkdtemp(prefix="bench_cal_"))
    try:
        xml = manifest.resolve(cfg["writer"])(tmp, **cfg["scene"])
        scene, rcfg, _ = load_scene(xml, device="cuda")
        rcfg = dataclasses.replace(rcfg, max_depth=int(cfg["max_depth"]))
        for k in range(args.seeds):
            seed = args.first_seed + 7919 * k
            base = base_seed(seed)
            kept = [(render(scene, dataclasses.replace(rcfg, seed=base + i), sample_count=spp,
                            device="cuda", **cell.traffic["render"]), base + i, spp)
                    for i in range(int(cell.check["renders"]))]
            for name, dtype in (("sound", torch.float32), ("control", torch.bfloat16)):
                if name == "control" and k >= args.control_seeds:
                    continue
                t0 = time.perf_counter()
                r = judge(kept, xml, cfg, cell.check, seed, "cuda", dtype)
                print(json.dumps({"workload": args.workload, "seed": seed, "reading": name,
                                  **r, "seconds": time.perf_counter() - t0}), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
