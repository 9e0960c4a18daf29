"""Device time of the general path's intersection kernels (needs a CUDA GPU):

    python3 optix_renderer_tpu_torch/tools/time_isect.py [--root DIR] [--reps N] [--brute]

Without `--brute`: builds config A's LBVH (`make_tessellated_cornell` at
800x600: 100,012 triangles) and the three ray sets of `chip_smoke.py`
phase 7 from a numpy seed: 480,000 camera rays through random film
positions, and 480,000 cosine-distributed bounce rays and 480,000 shadow
rays toward the ceiling light from the first hits of 600,000 further
camera rays. Then times `isect_bvh` closest hit on the camera and the
bounce rays and any hit on the shadow rays. Beside each it prints the rows
(or nodes) read and the leaves tested per ray, and ptxas' registers and
spills of the kernel instances. Then the renders, in `chip_smoke.py`'s
order: phase 5's Cornell box (64 spp, depth 16, gaussian; the path
kernel's small branch), config A (4 spp, depth 8, gaussian), `bench.py`'s
400x300 config of the same scene, and config M (the 8,012-triangle scene
of the path kernel's medium branch, 16 spp, depth 16).

With `--brute`: times `isect_brute`, the brute-force sweep, on 480,000 rays
against 12, 64 and 252 triangles (`brute_sets`), each beside its bound,
and counts the instructions per ray-triangle pair of its sweep loops in
the built library's SASS (`sweep_loops`, where the toolkit has
`cuobjdump`); then the renders that run it: config B (the Cornell box,
mitchell filter, 800x600, depth 16, 4 spp) and config B-252 (the same at
252 triangles, `make_tessellated_cornell(..., nu=10, nv=7)`).

Kernel times are device time: CUDA events around each launch behind a
spin (`device_ms`), `reps` launches after a warm-up, their median and
each of them. Each render cell is built `reps` times (the preset's
`load_scene`, timed), then rendered end to end on the host's clock with
the film on the host, `reps` times after a warm-up; a path-kernel cell's
table packing (`mega_step`) and the film readout (`_layers_out` of an
800x600 film) are timed alone after it. A checkout whose presets take a
device builds the cells on the card (`<cell>_card`, the default), then
again on the host (`<cell>_host`, which `render()` copies to the card
each time); an older one on the host. `--root` imports the package from
another checkout (for instance a parent commit unpacked with `git
archive`), so that two versions can be timed in one run on one card; a
checkout whose `isect_bvh` takes the packed skip-link table (before the
child-pair walk) is called that way. Prints one JSON line with the card's
name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

# rays per launch: one per pixel of an 800x600 film
MAIN_RAYS = 800 * 600
# the published H100 SXM peaks (FP32 outside the tensor cores, HBM3); the
# FP32 operations of one Moller-Trumbore test with its interval checks
# (csrc/walk.cuh: mt) and of a ray's direction reciprocal; the bytes an
# intersection call must move per ray: o, d, mint, cutoff in, id, t, u, v out
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
OPS_MT = 52
OPS_RAY = 9
RAY_BYTES = 48


def brute_bound(n: int, t_cnt: int) -> dict:
    """The least time of `isect_brute` on n rays x t_cnt triangles: the
    larger of the operations over the FP32 peak and the bytes over the
    memory rate. The FP32 peak counts a fused multiply-add as two
    operations; the library is built without contraction (-fmad=false),
    so its operations can run at half that rate at most (`fmad_free_ms`)."""
    ops_ms = (n * t_cnt * OPS_MT + n * OPS_RAY) / PEAK_FP32 * 1e3
    bytes_ms = (n * RAY_BYTES + t_cnt * 36) / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "fmad_free_ms": max(2 * ops_ms, bytes_ms)}


def camera_rays(scene, cfg, n, rng, dev):
    """n camera rays through uniformly random film positions (numpy seed)."""
    import torch

    from optix_renderer_tpu_torch.ops.camera import sample_ray

    pos = rng.uniform((0.0, 0.0), (cfg.width, cfg.height), (n, 2)).astype(np.float32)
    ap = rng.uniform(size=(n, 2)).astype(np.float32)
    ray, _ = sample_ray(scene.camera.to(dev), cfg.width, cfg.height,
                        torch.from_numpy(pos).to(dev), torch.from_numpy(ap).to(dev))
    return ray


def pixel_rays(scene, cfg, frames, rng, dev):
    """One camera ray per pixel in row order, jittered within its pixel
    (numpy seed), `frames` times over: the order in which the scan path
    emits a sample's camera rays."""
    import torch

    from optix_renderer_tpu_torch.ops.camera import sample_ray

    ys, xs = np.mgrid[0:cfg.height, 0:cfg.width]
    pix = np.tile(np.stack([xs.ravel(), ys.ravel()], axis=1), (frames, 1))
    pos = (pix + rng.uniform(size=pix.shape)).astype(np.float32)
    ap = rng.uniform(size=pix.shape).astype(np.float32)
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


def brute_sets(isect, dev, rng) -> dict:
    """{name: (tri [T, 9], (o, d, mint, cutoff))}, MAIN_RAYS rays each:
    t12_camera, the Cornell box's 12 triangles and camera rays through
    random film positions (as phase 7); t64_soup, a seeded 64-triangle soup
    and rays of random origin and direction; t252_camera, config B-252's
    252 triangles and one camera ray per pixel in row order; t252_bounce,
    cosine-distributed bounce rays from the first hits of two such frames,
    in the same order."""
    import torch

    from optix_renderer_tpu_torch.scene.presets import make_cornell_box, make_tessellated_cornell

    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    rays = lambda r: (r.o, r.d, r.mint, r.maxt)
    scene, cfg, _ = make_cornell_box(800, 600, 4, "path_mis", **device_kw(make_cornell_box, dev))
    sets = {"t12_camera": (scene.geometry.to(dev).tri_table,
                           rays(camera_rays(scene, cfg, MAIN_RAYS, rng, dev)))}
    soup = np.concatenate([rng.uniform(-1, 1, (64, 3)), rng.normal(0, 0.2, (64, 6))], axis=1)
    d = rng.normal(size=(MAIN_RAYS, 3))
    sets["t64_soup"] = (f32(soup), (f32(rng.uniform(-1.5, 1.5, (MAIN_RAYS, 3))),
                                    f32(d / np.linalg.norm(d, axis=1, keepdims=True)),
                                    f32(np.full(MAIN_RAYS, 1e-4)),
                                    f32(np.full(MAIN_RAYS, 3.4e38))))
    scene, cfg, _ = make_tessellated_cornell(800, 600, 4, "path_mis", nu=10, nv=7,
                                             **device_kw(make_tessellated_cornell, dev))
    geom = scene.geometry.to(dev)
    sets["t252_camera"] = (geom.tri_table, rays(pixel_rays(scene, cfg, 1, rng, dev)))
    more = pixel_rays(scene, cfg, 2, rng, dev)
    hits = isect.mt_sweep_ref(*rays(more), geom.tri_v0, geom.tri_e1, geom.tri_e2)
    bounce, _ = bounce_and_shadow_rays(geom, more, hits[0], hits[1], rng)
    sets["t252_bounce"] = (geom.tri_table, tuple(x[:MAIN_RAYS].contiguous() for x in rays(bounce)))
    return sets


def sphere_soup(isect, dev, rng, n_sph: int = 10000, n_rays: int = MAIN_RAYS):
    """A seeded soup of n_sph spheres (centres uniform in [-5, 5]^3, radii
    uniform in [0.02, 0.2]) as a scene's `Bvh` over them (ops/bvh.py:
    build_sphere_tables), n_rays camera rays from (0, 0, -12) toward
    uniform points of the square z = 0, |x|, |y| <= 5, and shadow rays from
    their closest hits (`isect.isect_spheres`) toward uniform points of a
    light square at y = 8, each cut 1e-4 short of it. Returns (bvh,
    camera, shadow), the rays as (o, d, mint, cutoff) on `dev`."""
    import torch

    from optix_renderer_tpu_torch.ops import bvh as bvh_mod
    from optix_renderer_tpu_torch.scene.data import Bvh

    f32 = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    center = rng.uniform(-5, 5, (n_sph, 3)).astype(np.float32)
    radius = rng.uniform(0.02, 0.2, n_sph).astype(np.float32)
    packed, leaf = bvh_mod.build_sphere_tables(center, radius)
    tree = Bvh(packed=f32(packed), leaf=f32(leaf), pairs=f32(bvh_mod.pack_child_pairs(packed)))
    target = np.concatenate([rng.uniform(-5, 5, (n_rays, 2)), np.zeros((n_rays, 1))], axis=1)
    o = np.tile(np.float32([0.0, 0.0, -12.0]), (n_rays, 1))
    d = target - o
    cam = (f32(o), f32(d / np.linalg.norm(d, axis=1, keepdims=True)),
           f32(np.full(n_rays, 1e-4)), f32(np.full(n_rays, 3.4e38)))
    ids, t = isect.isect_spheres(tree, *cam)
    p = cam[0] + cam[1] * torch.where(ids >= 0, t, 0.0)[:, None]
    light = f32(np.concatenate([rng.uniform(-3, 3, (n_rays, 1)), np.full((n_rays, 1), 8.0),
                                rng.uniform(-3, 3, (n_rays, 1))], axis=1))
    to_l = light - p
    dist = torch.linalg.vector_norm(to_l, dim=1)
    shadow = (p, to_l / dist[:, None], cam[2], dist - 1e-4)
    return tree, cam, shadow


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


def sweep_loops(sass: str, kernel: str = "brute_kernel") -> dict:
    """Instructions per ray-triangle pair of each sweep loop, from the
    output of `cuobjdump -sass` on the built library: {function: [loop]}.
    A sweep loop is an innermost loop (a backward branch with no other
    inside it) that divides (MUFU). Its fast path leaves out every stretch
    that a forward branch jumps over and that calls a subroutine (the
    division's slow path); each pair takes one MUFU on it, so per_pair =
    fast_path / MUFUs."""
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        ins = []  # (address, opcode, branch target or None)
        line = r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);"
        for m in re.finditer(line, chunk):
            tgt = re.search(r"0x([0-9a-f]+)", m.group(3)) if m.group(2).startswith("BRA") else None
            ins.append((int(m.group(1), 16), m.group(2).split(".")[0],
                        int(tgt.group(1), 16) if tgt else None))
        back = [(t, a) for a, op, t in ins if t is not None and t <= a]
        loops = []
        for t0, a0 in back:
            if any((t, a) != (t0, a0) and t0 <= t and a <= a0 for t, a in back):
                continue  # not innermost
            body = [x for x in ins if t0 <= x[0] <= a0]
            skip = set()
            for a, op, t in body:
                if t is not None and t > a and any(o == "CALL" for b, o, _ in body if a < b < t):
                    skip.update(b for b, _, _ in body if a < b < t)
            fast = [op for a, op, _ in body if a not in skip]
            mufu = fast.count("MUFU")
            if mufu:
                hist = {}
                for op in fast:
                    hist[op] = hist.get(op, 0) + 1
                loops.append({"start": hex(t0), "end": hex(a0), "fast_path": len(fast),
                              "mufu": mufu, "per_pair": len(fast) / mufu,
                              "opcodes": dict(sorted(hist.items(), key=lambda kv: -kv[1]))})
        out[name] = loops
    return out


def library_sass(path) -> str:
    """`cuobjdump -sass` of the library at `path` ("" where the toolkit has
    no cuobjdump)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return ""
    return subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True).stdout


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


def profiled_ms(fn, reps: int, kernel: str) -> float:
    """Device time in ms per call of the CUDA kernels whose name holds
    `kernel`, from torch.profiler over `reps` calls of `fn()` after a
    warm-up: the kernel alone, without the launch gaps that an event
    interval holds, which matter for a kernel of a few microseconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and kernel in e.key) / 1e3 / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose optix_renderer_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--brute", action="store_true",
                    help="time isect_brute and the renders that run it (configs B, B-252)")
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
    if args.brute:
        print(json.dumps(_brute(args, isect, _build, render, dev, smi)))
        return 0
    scene, cfg, _ = make_tessellated_cornell(800, 600, 4, "path_mis",
                                             **device_kw(make_tessellated_cornell, dev))
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
    res["renders"] = _renders(render, dev, args.reps)
    print(json.dumps(res))
    return 0


def _brute(args, isect, _build, render, dev, smi) -> dict:
    """--brute: isect_brute's device time on each of `brute_sets`, then
    configs B and B-252 through render()."""
    import dataclasses

    from optix_renderer_tpu_torch.scene.presets import make_cornell_box, make_tessellated_cornell

    res = {"root": args.root, "gpu": smi, "mode": "brute",
           "ptxas": {k: v for k, v in ptxas_report(_build.last_build.get("ptxas", "")).items()
                     if "brute" in k}}
    sets = brute_sets(isect, dev, np.random.default_rng(7))
    res["sweep_loops"] = sweep_loops(library_sass(_build.library_path()))
    for name, (tri, rays) in sets.items():
        ms = device_ms(lambda: isect.isect_brute(tri, *rays), args.reps)
        res[name] = {"ms_median": float(np.median(ms)), "ms_each": ms,
                     "kernel_ms": profiled_ms(lambda: isect.isect_brute(tri, *rays), args.reps,
                                              "brute_kernel"),
                     **brute_bound(rays[0].shape[0], tri.shape[0])}
        if "kernel" in inspect.signature(isect.last_launch).parameters:
            res[name]["launch"] = isect.last_launch("brute")
    mitchell = {"max_depth": 16, "rfilter": "mitchell"}
    cells = {"config_b": (lambda **kw: make_cornell_box(800, 600, 4, "path_mis", **kw),
                          mitchell, 1, 4),
             "config_b252": (lambda **kw: make_tessellated_cornell(800, 600, 4, "path_mis",
                                                                   nu=10, nv=7, **kw),
                             mitchell, 1, 4)}
    res["renders"] = _time_renders(render, cells, dev, args.reps)
    return res


def device_kw(make, dev) -> dict:
    """{"device": dev} for a loader or preset that takes a device (scenes
    built on their device); {} for an older checkout's, which builds on the
    host."""
    return {"device": dev} if "device" in inspect.signature(make).parameters else {}


def _renders(render, dev, reps: int) -> dict:
    """Phase 5's Cornell box, config A, bench.py's 400x300 and config M,
    in chip_smoke.py's order, through `_time_renders`."""
    from optix_renderer_tpu_torch.scene.presets import make_cornell_box, make_tessellated_cornell

    gaussian = {"max_depth": 16, "rfilter": "gaussian"}
    cells = {
        "cornell": (lambda **kw: make_cornell_box(800, 600, 64, "path_mis", **kw), gaussian,
                    16, 64),
        "config_a": (lambda **kw: make_tessellated_cornell(800, 600, 4, "path_mis", **kw),
                     {**gaussian, "max_depth": 8}, 1, 4),
        "bench_400x300": (lambda **kw: make_tessellated_cornell(400, 300, 1, "path_mis", **kw),
                          {"max_depth": 8}, 4, 4),
        "config_m": (lambda **kw: make_tessellated_cornell(800, 600, 16, "path_mis", nu=40,
                                                           nv=51, **kw), gaussian, 1, 16),
    }
    return _time_renders(render, cells, dev, reps)


def _time_renders(render, cells, dev, reps: int) -> dict:
    """Each cell {name: (make, config fields, warm-up spp, spp)}, where
    `make(**kw)` builds (scene, cfg, extras): the build's seconds, `reps`
    times; the render's median wall seconds and Mpaths/s over `reps`
    renders after a warm-up, each ending with the film on the host; for a
    path-kernel cell its table packing alone; then the film readout alone.
    A checkout whose presets take a device builds every cell on the card
    (`<name>_card`), then every cell on the host (`<name>_host`), so its
    default runs in the same order of cells as an older checkout's, which
    builds on the host."""
    import dataclasses
    import time

    import torch

    from optix_renderer_tpu_torch.ops.cuda.pathk import pathk_eligible
    from optix_renderer_tpu_torch.render.mega_render import mega_step
    from optix_renderer_tpu_torch.render.render import _layers_out
    from optix_renderer_tpu_torch.scene.presets import make_cornell_box

    wheres = {"host": {}}
    if device_kw(make_cornell_box, dev):
        wheres = {"card": {"device": dev}, "host": {"device": "cpu"}}

    def secs(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    film = torch.zeros((3, 600, 800, 4), device=dev)
    out = {}
    for where, kw in wheres.items():
        for name, (make, fields, warm_spp, spp) in cells.items():
            rec = {"load_s": [secs(lambda: make(**kw)) for _ in range(reps)]}
            scene, cfg, _ = make(**kw)
            cfg = dataclasses.replace(cfg, **fields)
            render(scene, cfg, sample_count=warm_spp, device=dev)
            # the film on the host inside each render's clock
            rec["s_each"] = [secs(lambda: render(scene, cfg, sample_count=spp, device=dev))
                             for _ in range(reps)]
            if pathk_eligible(scene, cfg):
                rec["pack_s"] = [secs(lambda: mega_step(scene, cfg, dev)) for _ in range(reps)]
            rec["readout_s"] = [secs(lambda: _layers_out(film)) for _ in range(reps)]
            for k in [k for k in rec if k.endswith("_s") or k == "s_each"]:
                rec[f"{k.removesuffix('_each')}_median"] = float(np.median(rec[k]))
            rec["mpaths_median"] = cfg.width * cfg.height * spp / rec["s_median"] / 1e6
            out[f"{name}_{where}"] = rec
    return out


if __name__ == "__main__":
    raise SystemExit(main())
