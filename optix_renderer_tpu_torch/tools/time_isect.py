"""Device time of the general path's LBVH kernels on config A (needs a CUDA GPU):

    python3 optix_renderer_tpu_torch/tools/time_isect.py [--root DIR] [--reps N]

Builds config A's LBVH (`make_tessellated_cornell` at 800x600: 100,012
triangles) and the three ray sets of `chip_smoke.py` phase 7 from a numpy
seed: 480,000 camera rays through random film positions, and 480,000
cosine-distributed bounce rays and 480,000 shadow rays toward the ceiling
light from the first hits of 600,000 further camera rays. Then times
`isect_bvh` closest hit on the camera and the bounce rays and any hit on
the shadow rays: CUDA events around each launch, `reps` launches after a
warm-up, their median and each of them. Beside each it prints the rows (or
nodes) read and the leaves tested per ray, and ptxas' registers and spills
of the kernel instances. Then the renders around the kernel, end to end on
the host's clock with the film on the host, `reps` times after a warm-up:
config A (4 spp, depth 8, gaussian), `bench.py`'s 400x300 config of the
same scene, and config M (the 8,012-triangle scene of the path kernel's
medium branch, 16 spp, depth 16), which shares the scene build. `--root`
imports the package from another
checkout (for instance a parent commit unpacked with `git archive`), so
that two versions can be timed in one run on one card; a checkout whose
`isect_bvh` takes the packed skip-link table (before the child-pair walk)
is called that way. Prints one JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

# rays per launch: one per pixel of an 800x600 film
MAIN_RAYS = 800 * 600


def camera_rays(scene, cfg, n, rng, dev):
    """n camera rays through uniformly random film positions (numpy seed)."""
    import torch

    from optix_renderer_tpu_torch.ops.camera import sample_ray

    pos = rng.uniform((0.0, 0.0), (cfg.width, cfg.height), (n, 2)).astype(np.float32)
    ap = rng.uniform(size=(n, 2)).astype(np.float32)
    ray, _ = sample_ray(scene.camera.to(dev), cfg.width, cfg.height,
                        torch.from_numpy(pos).to(dev), torch.from_numpy(ap).to(dev))
    return ray


def bounce_and_shadow_rays(geom, ray, ids, t, rng):
    """From each first hit: a cosine-distributed bounce ray about the
    geometric normal (facing the viewer) and a shadow ray toward a random
    point of the ceiling light, both from numpy uniforms."""
    import torch

    from optix_renderer_tpu_torch.core.math import Ray, cross, dot, frame_to_world, make_frame
    from optix_renderer_tpu_torch.core.math import normalize

    dev = ray.o.device
    hit = ids >= 0
    o, d = ray.o[hit], ray.d[hit]
    p = o + d * t[hit][:, None]
    tid = ids[hit].long()
    n = normalize(cross(geom.tri_e1[tid], geom.tri_e2[tid]))
    n = torch.where((dot(n, d) > 0)[:, None], -n, n)
    m = p.shape[0]
    u = torch.from_numpy(rng.uniform(size=(m, 4)).astype(np.float32)).to(dev)
    r, phi = torch.sqrt(u[:, 0]), 2.0 * np.pi * u[:, 1]
    local = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                         torch.sqrt(torch.clamp(1.0 - u[:, 0], min=0.0))], dim=-1)
    eps = torch.full((m,), 1e-4, device=dev)
    bounce = Ray(o=p, d=frame_to_world(make_frame(n), local), mint=eps,
                 maxt=torch.full((m,), 3.4e38, device=dev))
    light = torch.stack([-0.4 + 0.8 * u[:, 2], torch.full_like(u[:, 2], 1.99),
                         -0.4 + 0.8 * u[:, 3]], dim=-1)
    to_l = light - p
    dist = torch.sqrt(dot(to_l, to_l))
    shadow = Ray(o=p, d=to_l / dist[:, None], mint=eps, maxt=dist - 1e-4)
    return bounce, shadow


def config_a_rays(isect_bvh, scene, cfg, rng, dev):
    """phase 7's ray sets on config A: camera, bounce and shadow rays,
    MAIN_RAYS each; `isect_bvh(o, d, mint, cutoff)` finds the first hits
    the bounce and shadow rays start from."""
    cam = camera_rays(scene, cfg, MAIN_RAYS, rng, dev)
    more = camera_rays(scene, cfg, 600000, rng, dev)
    bounce, shadow = bounce_and_shadow_rays(scene.geometry.to(dev), more,
                                            *isect_bvh(*more)[:2], rng)
    if shadow.o.shape[0] < MAIN_RAYS:
        raise AssertionError(f"only {shadow.o.shape[0]} bounce / shadow rays")
    bounce, shadow = (type(r)(*(x[:MAIN_RAYS].contiguous() for x in r)) for r in (bounce, shadow))
    return cam, bounce, shadow


def ptxas_report(text: str) -> dict[str, dict[str, int]]:
    """{kernel: {registers, spill_stores, spill_loads}} from `nvcc -Xptxas -v`."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", ln)):
            out[name]["registers"] = int(m.group(1))
    return out


def device_ms(fn, reps: int) -> list[float]:
    """Device time in ms of what each of `reps` calls of `fn()` enqueues,
    after a warm-up: CUDA events queued behind a ~2 ms spin kernel
    (`torch.cuda._sleep`), so that the interval holds the device's work and
    not the host's time to enqueue it."""
    import torch

    fn()
    ms = []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(4_000_000)
        ev[0].record()
        fn()
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose optix_renderer_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import dataclasses

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_isect needs a CUDA GPU (torch.cuda.is_available() is False)")
    from optix_renderer_tpu_torch.ops import bvh as bvh_mod
    from optix_renderer_tpu_torch.ops.cuda import _build, isect
    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.scene.presets import make_tessellated_cornell

    if not Path(isect.__file__).resolve().is_relative_to(Path(args.root).resolve()):
        raise SystemExit(f"imported {isect.__file__}, not the package under {args.root}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    scene, cfg, _ = make_tessellated_cornell(800, 600, 4, "path_mis")
    cfg = dataclasses.replace(cfg, max_depth=8, rfilter="gaussian")
    tree = scene.geometry.to(dev).bvh
    pairs = hasattr(bvh_mod, "pack_child_pairs")
    tables = (tree,) if pairs else (tree.packed, tree.leaf)
    walk = lambda *rays, **kw: isect.isect_bvh(*tables, *rays, **kw)
    cam, bounce, shadow = config_a_rays(walk, scene, cfg, np.random.default_rng(7), dev)
    res = {"root": args.root, "gpu": smi, "walk": "child pairs" if pairs else "skip links",
           "ptxas": {k: v for k, v in ptxas_report(_build.last_build.get("ptxas", "")).items()
                     if "bvh" in k}}
    for name, rays, any_hit in (("closest_camera", cam, False), ("closest_bounce", bounce, False),
                                ("any_shadow", shadow, True)):
        vis = walk(*rays, any_hit=any_hit, with_visits=True)[4].double().mean(dim=1)
        ms = device_ms(lambda: walk(*rays, any_hit=any_hit), args.reps)
        res[name] = {"ms_median": float(np.median(ms)), "ms_each": ms,
                     "rows_per_ray": float(vis[0]), "leaves_per_ray": float(vis[1])}
        if hasattr(isect, "last_launch"):
            res[name]["launch"] = isect.last_launch()
    res["renders"] = _renders(render, make_tessellated_cornell, scene, cfg, dev, args.reps)
    print(json.dumps(res))
    return 0


def _renders(render, make_tessellated_cornell, scene_a, cfg_a, dev, reps: int) -> dict:
    """Median wall seconds and Mpaths/s of `reps` renders of each cell,
    after a warm-up render, ending with the film on the host."""
    import dataclasses
    import time

    import torch

    scene_q, cfg_q, _ = make_tessellated_cornell(400, 300, 1, "path_mis")
    scene_m, cfg_m, _ = make_tessellated_cornell(800, 600, 16, "path_mis", nu=40, nv=51)
    cells = {"config_a": (scene_a, cfg_a, 1, 4),
             "bench_400x300": (scene_q, dataclasses.replace(cfg_q, max_depth=8), 4, 4),
             "config_m": (scene_m, dataclasses.replace(cfg_m, max_depth=16, rfilter="gaussian"),
                          1, 16)}
    out = {}
    for name, (scene, cfg, warm_spp, spp) in cells.items():
        render(scene, cfg, sample_count=warm_spp, device=dev)
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(scene, cfg, sample_count=spp, device=dev)  # returns the film on the host
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        out[name] = {"s_each": walls, "s_median": wall,
                     "mpaths_median": cfg.width * cfg.height * spp / wall / 1e6}
    return out


if __name__ == "__main__":
    raise SystemExit(main())
