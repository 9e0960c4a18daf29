"""Derive a medium-branch configuration's walk constants: the LBVH walk's
nodes and leaves per ray.

    python benchmarks/derive_walk.py tess-cornell-8k [--seed 12] [--rays 480000] [--device cuda]

Loads the configuration's scene with the program's `load_scene` and counts,
as chip_smoke.py phase 12 does, the skip-link walk's visits
(`ops/bvh.py: traverse_walk_ref`) on the scene's own LBVH for camera rays
through uniform film positions and, from their first hits, cosine bounce
rays (`tools/time_isect.py`: `camera_rays`, `bounce_and_shadow_rays`, numpy
seed `--seed`): the closest-hit rays' mean nodes and leaves, the `walk` of
the configuration's `work`. The shadow rays' any-hit walks toward the light
are printed beside them. Run once, when the constants are set; the
benchmark's runs only read them.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--seed", type=int, default=12)
    p.add_argument("--rays", type=int, default=800 * 600)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    import numpy as np
    import torch

    from harness import manifest
    from optix_renderer_tpu_torch.ops.bvh import traverse_walk_ref
    from optix_renderer_tpu_torch.scene.build import load_scene
    from optix_renderer_tpu_torch.tools.time_isect import bounce_and_shadow_rays, camera_rays

    m = manifest.load_manifest()
    cfg = [c for c in m["configs"] if c["name"] == args.config][0]
    cfg = json.loads((manifest.ROOT / cfg["file"]).read_text())
    with tempfile.TemporaryDirectory() as tmp:
        xml = manifest.resolve(cfg["writer"])(tmp, **cfg["scene"])
        scene, rcfg, _ = load_scene(xml, device=args.device)
    geom = scene.geometry
    packed, leaf = geom.bvh.packed, geom.bvh.leaf
    rng = np.random.default_rng(args.seed)
    with torch.no_grad():
        cam = camera_rays(scene, rcfg, args.rays, rng, args.device)
        first = traverse_walk_ref(packed, leaf, *cam, with_visits=True)
        bounce, shadow = bounce_and_shadow_rays(geom, cam, first[0], first[1], rng)
        closest = torch.cat([first[4], traverse_walk_ref(packed, leaf, *bounce,
                                                         with_visits=True)[4]], dim=1)
        any_hit = traverse_walk_ref(packed, leaf, *shadow, any_hit=True, with_visits=True)[4]
    mean = lambda v: [float(x) for x in v.double().mean(dim=1)]
    (nodes, leaves), (s_nodes, s_leaves) = mean(closest), mean(any_hit)
    print(json.dumps({"config": args.config, "seed": args.seed,
                      "closest_rays": closest.shape[1], "nodes_per_ray": nodes,
                      "leaves_per_ray": leaves, "shadow_rays": any_hit.shape[1],
                      "shadow_nodes_per_ray": s_nodes, "shadow_leaves_per_ray": s_leaves}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
