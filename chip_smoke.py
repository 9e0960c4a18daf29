"""Smoke test of the PyTorch / CUDA port on one GPU: `python3 chip_smoke.py`.

Drives the port's main path (`optix_renderer_tpu_torch`, no JAX) once:

1. needs a CUDA GPU; prints its name and power limit (nvidia-smi);
2. builds the CUDA kernel from the sources in this checkout;
3. compares the kernel with its plain torch version on the GPU (Cornell
   64×48, box filter, depth 4, 4 spp, path_mis and path_mats);
4. renders the golden configuration through the kernel and holds it
   against tests/golden/cbox_{path_mis,path_mats}.exr;
5. renders the Cornell box at 800×600, path_mis, depth 16, gaussian filter
   through `render()` (16-spp warm-up, then 64 spp timed, film copied to the
   host inside the clock), counts the kernel's launches in that run, times
   the 512-spp bench config, and
   times kernel and plain version at 800×600 × 16 spp, comparing the two;
6. runs the CLI on the GPU and checks it writes EXR and PNG;
7. compares the intersection kernels of the general path with their plain
   versions on the GPU at the main path's width, 480,000 rays a launch:
   `isect_bvh` closest hit on camera rays and on cosine-distributed bounce
   rays, and any hit on shadow rays toward the light, of the
   100,012-triangle tessellated Cornell box; `isect_brute` on camera rays of
   the Cornell box, and on a 4,096-triangle random soup so that several
   tiles run (ids equal on all but 1e-4 of the rays, and where they differ
   both t agree to 1e-5 relative; any-hit masks equal on all but 1e-4); the
   plain walks are timed on those calls;
8. renders config A, the tessellated Cornell box at 800x600, path_mis,
   depth 8, gaussian filter, through `render()` (1-spp warm-up, then 4 spp
   timed with the film on the host), counts the LBVH kernels' launches in
   that run, renders bench.py's 400x300 config, and times one closest-hit
   and one any-hit launch on phase 7's rays;
9. renders config B, the Cornell box at 800x600 with the mitchell filter,
   path_mis, depth 16, 4 spp, and counts `isect_brute`'s launches;
10. renders the golden configuration through the general path
   (`mega=False`) and holds it against tests/golden/cbox_{path_mis,path_mats}.exr.

Every phase raises on failure. The second-to-last line is a JSON object with
each kernel's route, source, launches, error, times and bound; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "optix_renderer_tpu_torch/csrc/pathk.cu"
REPLACES = "optix_renderer_tpu/ops/pallas/pathk.py:992"
ISECT_SOURCE = "optix_renderer_tpu_torch/csrc/isect.cu"
# the published H100 SXM peaks (FP32 outside the tensor cores, HBM3)
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations counted from csrc/isect.cu (and csrc/pathk.cu, mega.cuh):
# one Moller-Trumbore test with its interval checks, one slab test of a node,
# one sphere test; the per-ray reciprocal of the direction
OPS_MT = 52
OPS_SLAB = 25
OPS_SPHERE = 39
OPS_RAY = 9
# bytes per ray an intersection call must move: o, d, mint, cutoff in;
# id, t, u, v out
RAY_BYTES = 48
# rays per intersection launch of configs A and B (one per pixel)
MAIN_RAYS = 800 * 600


def phase(n: int, msg: str) -> None:
    print(f"[phase {n}] {msg}", flush=True)


def film(rows: torch.Tensor, h: int, w: int) -> dict:
    """Kernel rows [16, n_pix] → per-sample means of composite and albedo [h,w,3]."""
    r = rows.detach().cpu().numpy()
    n = np.maximum(r[3], 1e-9)
    return {"composite": (r[0:3] / n).T.reshape(h, w, 3),
            "albedo": (r[4:7] / n).T.reshape(h, w, 3), "n": r[3]}


def compare(a: dict, b: dict, n_spp: int, what: str) -> dict:
    """Kernel film `a` vs plain film `b`: every pixel holds n_spp samples,
    median |a−b|/(|a|+1e-3) < 1e-3, at most 1e-3 of the pixels differ by
    more than 1e-2 relative, means within 10 %, and albedo to atol 2e-3 in
    every pixel. The kernel is built without FMA contraction and matches
    the plain version bit for bit; the median and share bounds leave room
    for a Russian-roulette flip on a last-bit difference, never for a
    wrong branch."""
    for f, name in ((a, "kernel"), (b, "plain")):
        if not np.all(f["n"] == n_spp):
            raise AssertionError(f"{what}: {name} row 3 is not {n_spp} everywhere")
    ca, cb = a["composite"], b["composite"]
    rel = np.abs(ca - cb) / (np.abs(ca) + 1e-3)
    dalb = np.abs(a["albedo"] - b["albedo"]).max(axis=-1)
    stats = {"median_rel_err": float(np.median(rel)), "max_abs_err": float(np.abs(ca - cb).max()),
             "share_rel_over_1e-2": float((rel > 1e-2).mean()),
             "mean_kernel": float(ca.mean()), "mean_plain": float(cb.mean()),
             "albedo_max_abs_err": float(dalb.max()),
             "albedo_share_over_2e-3": float((dalb > 2e-3).mean())}
    print(f"  {what}: {json.dumps(stats)}", flush=True)
    if not stats["median_rel_err"] < 1e-3:
        raise AssertionError(f"{what}: median relative error {stats['median_rel_err']}")
    if not abs(stats["mean_kernel"] - stats["mean_plain"]) <= 0.1 * abs(stats["mean_plain"]):
        raise AssertionError(f"{what}: means differ by more than 10 %")
    if not stats["share_rel_over_1e-2"] <= 1e-3:
        raise AssertionError(f"{what}: {stats['share_rel_over_1e-2']} of the pixels differ by "
                             "more than 1e-2 relative")
    if not stats["albedo_max_abs_err"] <= 2e-3:
        raise AssertionError(f"{what}: albedo differs by {stats['albedo_max_abs_err']} "
                             f"in {stats['albedo_share_over_2e-3']} of the pixels")
    return stats


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) for `ops` FP32
    operations and `nbytes` bytes moved."""
    t_ops, t_bytes = ops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def event_ms(fn, reps: int = 1) -> float:
    """Mean CUDA-event time of `fn()` over `reps` calls, after one warm-up."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def timed(fn):
    """(fn(), its CUDA-event time in ms) for one call, no warm-up."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1])


def device_ms(fn, reps: int = 5) -> dict[str, float]:
    """Device time (ms per call) of each CUDA kernel that `fn()` launches,
    from torch.profiler over `reps` calls after one warm-up. Unlike
    `event_ms` it leaves out the wrapper's host time, which dominates a
    kernel of a few microseconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def camera_rays(scene, cfg, n, rng, dev):
    """n camera rays through uniformly random film positions (numpy seed)."""
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


def gate_closest(what, got, ref) -> float:
    """ids equal on all but 1e-4 of the rays; where they differ both t agree
    to 1e-5 relative. Returns max |t_kernel − t_plain|."""
    ids_k, t_k = got[0], got[1]
    ids_p, t_p = ref[0], ref[1]
    diff = ids_k != ids_p
    share = float(diff.float().mean())
    rel = (t_k - t_p).abs() / t_p.abs().clamp(min=1e-30)
    worst = float(rel[diff].max()) if bool(diff.any()) else 0.0
    max_abs = float((t_k - t_p).abs().max())
    print(f"  {what}: {ids_k.numel()} rays, hits {float((ids_k >= 0).float().mean()):.4f}, "
          f"ids differ on {share:.2e}, worst t rel err there {worst:.2e}, "
          f"max |dt| {max_abs:.3e}", flush=True)
    if not (share <= 1e-4 and worst <= 1e-5):
        raise AssertionError(f"{what}: ids differ on {share} of the rays (t rel err {worst})")
    return max_abs


def gate_any(what, got, ref) -> float:
    """Any-hit masks equal on all but 1e-4 of the rays. Returns max
    |t_kernel − t_plain| over the rays whose masks agree."""
    mk, mp = got[0] >= 0, ref[0] >= 0
    same = mk == mp
    share = float((~same).float().mean())
    max_abs = float((got[1] - ref[1])[same].abs().max())
    print(f"  {what}: {mk.numel()} rays, occluded {float(mk.float().mean()):.4f}, "
          f"masks differ on {share:.2e}, max |dt| where they agree {max_abs:.3e}", flush=True)
    if not share <= 1e-4:
        raise AssertionError(f"{what}: any-hit masks differ on {share} of the rays")
    return max_abs


def golden_stats(out, ref) -> dict:
    """tests/test_golden.py's statistic, max |a−b|/(|ref|+1e-2), with the
    pixels over 1e-3, the median and the means."""
    err = (np.abs(out - ref) / (np.abs(ref) + 1e-2)).max(axis=-1)
    return {"max": float(err.max()), "median": float(np.median(err)),
            "pixels_over_1e-3": int((err > 1e-3).sum()),
            "mean": float(out.mean()), "mean_ref": float(ref.mean())}


def main() -> None:
    # ---- 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phase(1, f"gpu: {smi}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from optix_renderer_tpu_torch.ops import bvh
    from optix_renderer_tpu_torch.ops.cuda import _build, isect, pathk
    from optix_renderer_tpu_torch.render.film import in_footprints
    from optix_renderer_tpu_torch.render.render import _layers_out, render
    from optix_renderer_tpu_torch.scene.presets import (
        cornell_box_xml,
        make_cornell_box,
        make_tessellated_cornell,
    )
    from optix_renderer_tpu_torch.utils.imageio import read_exr

    dev = torch.device("cuda", 0)

    # ---- 2. build the kernel
    t0 = time.time()
    _build.load()
    info = _build.last_build
    regs = [ln.strip() for ln in info.get("ptxas", "").splitlines()
            if "registers" in ln or "spill" in ln]
    phase(2, f"built {Path(info['path']).name} in {time.time() - t0:.2f} s")
    for ln in regs:
        print(f"  ptxas: {ln}")

    # ---- 3. kernel vs plain version on the card, small Cornell
    for integ in ("path_mis", "path_mats"):
        scene, cfg, _ = make_cornell_box(64, 48, 4, integ)
        cfg = dataclasses.replace(cfg, max_depth=4, rfilter="box")
        tables, meta = pathk.build_pathk_tables(scene, cfg, dev)
        n_pix = cfg.width * cfg.height
        got = pathk.pathk_trace(tables, meta, cfg, n_pix=n_pix, spp0=0, n_spp=4)
        ref = pathk.pathk_trace_ref(tables, meta, cfg, n_pix=n_pix, spp0=0, n_spp=4)
        torch.cuda.synchronize()
        compare(film(got, 48, 64), film(ref, 48, 64), 4, f"64x48 box {integ}")
    phase(3, "kernel agrees with the plain version (64x48, box, depth 4, 4 spp)")

    # ---- 4. golden images (tools/gen_golden.py config) through the kernel.
    # The goldens are splatted films; the kernel's film is filter-importance
    # sampled and noisier per pixel. path_mats (no NEE) at 8 spp gives a
    # per-pixel error of 0.6655 for the JAX path kernel too (see
    # tests/test_torch_pathk.py: test_golden_per_pixel_statistic_of_jax_kernel),
    # so its check runs on 4x4-pixel block means; path_mis is checked per pixel.
    for integ, block in (("path_mis", 1), ("path_mats", 4)):
        scene, cfg, _ = make_cornell_box(64, 48, 1, integ)
        cfg = dataclasses.replace(cfg, max_depth=4, rfilter="gaussian")
        b = render(scene, cfg, sample_count=8, device=dev)["composite"]
        a = read_exr(ROOT / "tests" / "golden" / f"cbox_{integ}.exr")[..., :3]
        mean_ok = abs(a.mean() - b.mean()) <= 0.05 * abs(a.mean())
        ab, bb = (x.reshape(48 // block, block, 64 // block, block, 3).mean((1, 3)) for x in (a, b))
        err = float(np.mean(np.abs(ab - bb) / (np.abs(ab) + 0.05)))
        print(f"  golden {integ}: mean {a.mean():.5f} vs {b.mean():.5f}, "
              f"mean rel err {err:.4f} over {block}x{block} blocks")
        if not (mean_ok and err < 0.35):
            raise AssertionError(f"golden {integ} check failed")
    phase(4, "golden check holds (means within 5 %, mean rel err < 0.35)")

    # ---- 5. the main path at full size
    scene, cfg, _ = make_cornell_box(800, 600, 64, "path_mis")
    cfg = dataclasses.replace(cfg, max_depth=16, rfilter="gaussian")
    render(scene, cfg, sample_count=16, device=dev)  # warm-up
    pathk.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out = render(scene, cfg, sample_count=64, device=dev)  # returns host numpy
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = pathk.LAUNCHES
    comp = out["composite"]
    mpaths = cfg.width * cfg.height * 64 / dt / 1e6
    if launches < 1:
        raise AssertionError("the main path launched the kernel no time")
    if not (np.isfinite(comp).all() and comp.shape == (600, 800, 3) and comp.mean() > 0):
        raise AssertionError("800x600 film is not finite / positive")
    print(f"  800x600 path_mis depth 16 gaussian, 64 spp: {dt:.4f} s, {mpaths:.3f} Mpaths/s "
          f"on {smi}; {launches} kernel launches; film mean {comp.mean():.5f}")
    t0 = time.time()
    render(scene, cfg, sample_count=512, device=dev)  # the bench.py config
    dt512 = time.time() - t0
    print(f"  800x600 path_mis depth 16 gaussian, 512 spp: {dt512:.4f} s, "
          f"{cfg.width * cfg.height * 512 / dt512 / 1e6:.3f} Mpaths/s on {smi}")

    # host side of render(): table packing and film readout
    t0 = time.time()
    tables, meta = pathk.build_pathk_tables(scene, cfg, dev)
    torch.cuda.synchronize()
    pack_ms = (time.time() - t0) * 1e3
    acc = torch.zeros((3, cfg.height, cfg.width, 4), device=dev)
    torch.cuda.synchronize()
    t0 = time.time()
    _layers_out(acc)
    readout_ms = (time.time() - t0) * 1e3
    print(f"  host: table packing {pack_ms:.3f} ms, film readout {readout_ms:.3f} ms")
    n_pix = cfg.width * cfg.height
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    reps = 3
    ev[0].record()
    for _ in range(reps):
        got = pathk.pathk_trace(tables, meta, cfg, n_pix=n_pix, spp0=0, n_spp=16)
    ev[1].record()
    ref = pathk.pathk_trace_ref(tables, meta, cfg, n_pix=n_pix, spp0=0, n_spp=16)
    ev[2].record()
    torch.cuda.synchronize()
    kernel_ms = ev[0].elapsed_time(ev[1]) / reps
    plain_ms = ev[1].elapsed_time(ev[2])
    stats = compare(film(got, 600, 800), film(ref, 600, 800), 16, "800x600 gaussian depth 16")
    # bound: the FP32 operations every loop iteration does at least (the
    # closest-hit sweep over the triangles and spheres, csrc/pathk.cu step 1
    # and 3) times the summed per-pixel iteration count (row 10)
    iters = float(got[10].double().sum())
    pathk_ops = iters * (meta["t_cnt"] * OPS_MT + meta["n_sph"] * OPS_SPHERE + 5)
    pathk_bound, pathk_by = bound(pathk_ops, 16 * 4 * n_pix)
    print(f"  800x600 x 16 spp: kernel {kernel_ms:.3f} ms, plain version {plain_ms:.3f} ms, "
          f"bound {pathk_bound:.4f} ms ({pathk_by}; {iters:.0f} iterations) on {smi}")
    phase(5, f"main path: {mpaths:.3f} Mpaths/s, {launches} launches")

    # ---- 6. the CLI on the card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        xml = cornell_box_xml(tmp, 64, 48, 4, "path_mis")
        subprocess.run([sys.executable, "-m", "optix_renderer_tpu_torch", "render", str(xml),
                        "--device", "cuda", "--spp", "4", "--size", "64x48"],
                       cwd=ROOT, check=True, timeout=600)
        exr, png = xml.with_suffix(".exr"), xml.with_suffix(".png")
        img = read_exr(exr)
        if not (png.stat().st_size > 0 and img.shape == (48, 64, 3) and np.isfinite(img).all()):
            raise AssertionError("CLI output is missing or malformed")
    phase(6, "CLI rendered on cuda and wrote EXR + PNG")

    # ---- 7. the general path's intersection kernels vs their plain versions
    rng = np.random.default_rng(7)
    t0 = time.time()
    scene_a, cfg_a, _ = make_tessellated_cornell(800, 600, 4, "path_mis")
    cfg_a = dataclasses.replace(cfg_a, max_depth=8, rfilter="gaussian")
    geom_a = scene_a.geometry.to(dev)
    packed, leaf = geom_a.bvh.packed, geom_a.bvh.leaf
    print(f"  config A: {cfg_a.n_tris} triangles, {packed.shape[0]} nodes, "
          f"{leaf.shape[0]} leaves, built in {time.time() - t0:.2f} s")
    # the main path's width: 480,000 camera rays, and 480,000 bounce and
    # shadow rays each from the hits of 600,000 further camera rays
    prim_a = camera_rays(scene_a, cfg_a, MAIN_RAYS, rng, dev)
    more = camera_rays(scene_a, cfg_a, 600000, rng, dev)
    bounce_a, shadow_a = bounce_and_shadow_rays(
        geom_a, more, *isect.isect_bvh(packed, leaf, *more)[:2], rng)
    if shadow_a.o.shape[0] < MAIN_RAYS:
        raise AssertionError(f"only {shadow_a.o.shape[0]} bounce / shadow rays")
    bounce_a, shadow_a = (type(r)(*(x[:MAIN_RAYS].contiguous() for x in r))
                          for r in (bounce_a, shadow_a))
    ref, plain_closest = timed(lambda: bvh.traverse_walk_ref(packed, leaf, *prim_a))
    err_bvh = gate_closest("isect_bvh closest, camera rays",
                           isect.isect_bvh(packed, leaf, *prim_a), ref)
    err_bvh = max(err_bvh, gate_closest("isect_bvh closest, bounce rays",
                                        isect.isect_bvh(packed, leaf, *bounce_a),
                                        bvh.traverse_walk_ref(packed, leaf, *bounce_a)))
    ref, plain_any = timed(lambda: bvh.traverse_walk_ref(packed, leaf, *shadow_a, any_hit=True))
    err_any = gate_any("isect_bvh any, shadow rays",
                       isect.isect_bvh(packed, leaf, *shadow_a, any_hit=True), ref)
    print(f"  plain walk, {MAIN_RAYS} rays: closest {plain_closest:.3f} ms, "
          f"any {plain_any:.3f} ms on {smi}")
    scene_b, cfg_b, _ = make_cornell_box(800, 600, 4, "path_mis")
    cfg_b = dataclasses.replace(cfg_b, max_depth=16, rfilter="mitchell")
    geom_b = scene_b.geometry.to(dev)
    prim_b = camera_rays(scene_b, cfg_b, MAIN_RAYS, rng, dev)
    tri_b = geom_b.tri_table
    tris_b = (geom_b.tri_v0, geom_b.tri_e1, geom_b.tri_e2)
    err_brute = gate_closest("isect_brute, Cornell triangles, camera rays",
                             isect.isect_brute(tri_b, *prim_b),
                             isect.mt_sweep_ref(*prim_b, *tris_b))
    soup = tuple(torch.from_numpy(x.astype(np.float32)).to(dev) for x in (
        rng.uniform(-1, 1, (4096, 3)), rng.normal(0, 0.2, (4096, 3)),
        rng.normal(0, 0.2, (4096, 3))))
    o_s = torch.from_numpy(rng.uniform(-1.5, 1.5, (65536, 3)).astype(np.float32)).to(dev)
    d_s = torch.nn.functional.normalize(torch.from_numpy(
        rng.normal(size=(65536, 3)).astype(np.float32)).to(dev), dim=-1)
    rays_s = (o_s, d_s, torch.full((65536,), 1e-4, device=dev),
              torch.full((65536,), 3.4e38, device=dev))
    err_brute = max(err_brute, gate_closest("isect_brute, 4096-triangle soup",
                                            isect.isect_brute(torch.cat(soup, dim=1), *rays_s),
                                            isect.mt_sweep_ref(*rays_s, *soup)))
    phase(7, "isect_bvh (closest, any) and isect_brute agree with their plain versions "
             f"at {MAIN_RAYS} rays")

    # ---- 8. config A through render(): the LBVH kernels on the main path
    render(scene_a, cfg_a, sample_count=1, device=dev)  # warm-up
    for k in isect.LAUNCHES:
        isect.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out_a = render(scene_a, cfg_a, sample_count=4, device=dev)  # returns host numpy
    dt_a = time.time() - t0
    launches_a = dict(isect.LAUNCHES)
    comp = out_a["composite"]
    print(f"  config A 800x600 path_mis depth 8 gaussian, 4 spp: {dt_a:.4f} s, "
          f"{800 * 600 * 4 / dt_a / 1e6:.4f} Mpaths/s on {smi}; launches {launches_a}; "
          f"film mean {comp.mean():.5f}")
    if not (launches_a["isect_bvh_closest"] > 0 and launches_a["isect_bvh_any"] > 0):
        raise AssertionError(f"config A launched an LBVH kernel no time: {launches_a}")
    if not (np.isfinite(comp).all() and comp.shape == (600, 800, 3) and comp.mean() > 0):
        raise AssertionError("config A film is not finite / positive")
    scene_q, cfg_q, _ = make_tessellated_cornell(400, 300, 1, "path_mis")
    cfg_q = dataclasses.replace(cfg_q, max_depth=8)
    render(scene_q, cfg_q, sample_count=4, device=dev)  # warm-up, as bench.py's _run
    t0 = time.time()
    out_q = render(scene_q, cfg_q, sample_count=4, device=dev)
    dt_q = time.time() - t0
    print(f"  bench.py mesh100k config 400x300 path_mis depth 8, 4 spp: {dt_q:.4f} s, "
          f"{400 * 300 * 4 / dt_q / 1e6:.4f} Mpaths/s on {smi}; film mean "
          f"{out_q['composite'].mean():.5f}")
    # one launch each on phase 7's rays: 480,000 camera rays (closest hit) and
    # 480,000 shadow rays (any hit)
    first_a = isect.isect_bvh(packed, leaf, *prim_a, with_visits=True)
    any_a = isect.isect_bvh(packed, leaf, *shadow_a, any_hit=True, with_visits=True)
    ms_closest = event_ms(lambda: isect.isect_bvh(packed, leaf, *prim_a), reps=5)
    ms_any = event_ms(lambda: isect.isect_bvh(packed, leaf, *shadow_a, any_hit=True), reps=5)
    dev_closest = device_ms(lambda: isect.isect_bvh(packed, leaf, *prim_a))
    print(f"  isect_bvh closest, {MAIN_RAYS} rays, device time per call (ms): "
          + "; ".join(f"{k[:40]} {v:.4f}" for k, v in dev_closest.items()))
    table_bytes = (packed.numel() + leaf.numel()) * 4

    def walk_bound(visits):
        """(bound: the operations this run's walk does, against the bytes the
        function must move, rays in and out and the tables read once;
        the time of every node and leaf read from device memory, which the
        L2-resident tables mostly avoid)"""
        nodes, leaves = (float(x) for x in visits.double().sum(dim=1))
        n_rays = visits.shape[1]
        need = bound(nodes * OPS_SLAB + leaves * 4 * (OPS_MT + 1) + n_rays * OPS_RAY,
                     n_rays * RAY_BYTES + table_bytes)
        return need, (nodes * 32 + leaves * 160) / PEAK_BYTES * 1e3

    (b_closest, visit_closest), (b_any, visit_any) = walk_bound(first_a[4]), walk_bound(any_a[4])
    for what, ms, b, visit_ms, vis in (("closest, camera", ms_closest, b_closest, visit_closest,
                                        first_a[4]),
                                       ("any, shadow", ms_any, b_any, visit_any, any_a[4])):
        print(f"  isect_bvh {what} rays, {MAIN_RAYS}: {ms:.4f} ms (bound {b[0]:.4f} ms, {b[1]}; "
              f"every visit from device memory {visit_ms:.4f} ms; "
              f"{float(vis[0].float().mean()):.1f} nodes, {float(vis[1].float().mean()):.2f} "
              f"leaves per ray) on {smi}")
    # where the time of a config A sample goes: device time by kernel and the
    # device's idle share of the wall clock (torch.profiler; only the CUDA
    # events are summed, since each CPU op's row repeats its kernels' time)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        render(scene_a, cfg_a, sample_count=1, device=dev)
        wall_1 = time.time() - t0
    dev_us = {e.key: e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA}
    busy = sum(dev_us.values()) / 1e6
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    print(f"  config A, 1 spp under the profiler: wall {wall_1:.4f} s, device busy {busy:.4f} s "
          f"in {sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)} "
          f"kernels, idle share {1.0 - busy / wall_1:.4f}; top device time (ms): "
          + "; ".join(f"{k[:50]} {v / 1e3:.3f}" for k, v in top))
    phase(8, f"config A: {800 * 600 * 4 / dt_a / 1e6:.4f} Mpaths/s, launches {launches_a}")

    # ---- 9. config B through render(): the brute-force kernel on the main path
    render(scene_b, cfg_b, sample_count=1, device=dev)  # warm-up
    for k in isect.LAUNCHES:
        isect.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out_b = render(scene_b, cfg_b, sample_count=4, device=dev)
    dt_b = time.time() - t0
    launches_b = dict(isect.LAUNCHES)
    comp = out_b["composite"]
    print(f"  config B 800x600 mitchell path_mis depth 16, 4 spp: {dt_b:.4f} s, "
          f"{800 * 600 * 4 / dt_b / 1e6:.4f} Mpaths/s on {smi}; launches {launches_b}; "
          f"film mean {comp.mean():.5f}")
    if not launches_b["isect_brute"] > 0:
        raise AssertionError(f"config B launched isect_brute no time: {launches_b}")
    if not (np.isfinite(comp).all() and comp.shape == (600, 800, 3) and comp.mean() > 0):
        raise AssertionError("config B film is not finite / positive")
    brute_dev = device_ms(lambda: isect.isect_brute(tri_b, *prim_b))
    ms_brute = sum(v for k, v in brute_dev.items() if "brute_kernel" in k)
    wrapper_brute = event_ms(lambda: isect.isect_brute(tri_b, *prim_b), reps=5)
    plain_brute = event_ms(lambda: isect.mt_sweep_ref(*prim_b, *tris_b))
    t_b = tri_b.shape[0]
    b_brute = bound(MAIN_RAYS * t_b * OPS_MT + MAIN_RAYS * OPS_RAY,
                    MAIN_RAYS * RAY_BYTES + t_b * 36)
    print(f"  isect_brute, {MAIN_RAYS} rays x {t_b} triangles: kernel {ms_brute:.4f} ms (bound "
          f"{b_brute[0]:.4f} ms, {b_brute[1]}), whole wrapper call {wrapper_brute:.4f} ms; "
          f"plain version {plain_brute:.3f} ms on {smi}")
    phase(9, f"config B: {800 * 600 * 4 / dt_b / 1e6:.4f} Mpaths/s, launches {launches_b}")

    # ---- 10. the general path against the goldens (tools/gen_golden.py config)
    for integ in ("path_mis", "path_mats"):
        scene, cfg, _ = make_cornell_box(64, 48, 1, integ)
        cfg = dataclasses.replace(cfg, max_depth=4, rfilter="gaussian")
        b = render(scene, cfg, sample_count=8, device=dev, mega=False)["composite"]
        a = read_exr(ROOT / "tests" / "golden" / f"cbox_{integ}.exr")[..., :3]
        st = golden_stats(b, a)
        print(f"  golden {integ} through the scan path: {json.dumps(st)}")
        # tests/test_golden.py's bound; else at most two samples of the 8 × 3072
        # take another branch than in the JAX film: every pixel over the bound
        # lies inside two filter footprints (tests/test_torch_general.py)
        over = (np.abs(b - a) / (np.abs(a) + 1e-2)).max(axis=-1) > 1e-3
        ok = st["max"] < 1e-3 or (st["median"] < 1e-4 and in_footprints(over, cfg.rfilter, 2)
                                   and abs(st["mean"] - st["mean_ref"]) <= 1e-3 * st["mean_ref"])
        if not ok:
            raise AssertionError(f"golden {integ} through the scan path: {st}")
    phase(10, "the scan path reproduces the goldens")

    def row(name, source, replaces, launches, err, ms, plain_ms, bnd, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        row("pathk_trace", KERNEL_SOURCE, REPLACES, launches, stats["max_abs_err"], kernel_ms,
            plain_ms, (pathk_bound, pathk_by), median_rel_err=stats["median_rel_err"]),
        row("isect_bvh_closest", ISECT_SOURCE, "optix_renderer_tpu/ops/pallas/cluster.py:454",
            launches_a["isect_bvh_closest"], err_bvh, ms_closest, plain_closest, b_closest,
            rays=MAIN_RAYS, visit_bytes_hbm_ms=visit_closest),
        row("isect_bvh_any", ISECT_SOURCE, "optix_renderer_tpu/ops/pallas/cluster.py:454",
            launches_a["isect_bvh_any"], err_any, ms_any, plain_any, b_any, rays=MAIN_RAYS,
            visit_bytes_hbm_ms=visit_any),
        row("isect_brute", ISECT_SOURCE, "optix_renderer_tpu/ops/pallas/mxu_intersect.py:195",
            launches_b["isect_brute"], err_brute, ms_brute, plain_brute, b_brute, rays=MAIN_RAYS,
            also_replaces="optix_renderer_tpu/ops/pallas/mt_kernel.py:140"),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
