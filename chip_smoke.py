"""Smoke test of the PyTorch / CUDA port on one GPU: `python3 chip_smoke.py`.

Drives the port's main path (`optix_renderer_tpu_torch`, no JAX) once:

1. needs a CUDA GPU; prints its name and power limit (nvidia-smi);
2. builds the CUDA kernel from the sources in this checkout and prints
   ptxas' registers and spills of the small branch `pathk_kernel<MIS>`;
3. holds the kernel's rows bit for bit against its plain torch version on
   the GPU (Cornell 64×48, box filter, depth 4, 4 spp, path_mis and
   path_mats), prints the launch's grid and resident blocks per SM, and
   checks that the launcher refuses a launch without its pixel counter;
4. renders the golden configuration through the kernel and holds it
   against tests/golden/cbox_{path_mis,path_mats}.exr;
5. renders the Cornell box at 800×600, path_mis, depth 16, gaussian filter
   through `render()` (16-spp warm-up, then 64 spp timed, film copied to the
   host inside the clock), counts the kernel's launches in that run, times
   the 512-spp bench config, and
   times kernel and plain version at 800×600 × 16 spp, holding the rows
   bit for bit, and prints the share of lane iterations that do work from
   row 10 (warps of 32 fixed pixels, blocks of 128, and the refill model of
   the kernel's persistent grid);
6. runs the CLI on the GPU and checks it writes EXR and PNG;
7. compares the intersection kernels of the general path with their plain
   versions on the GPU at the main path's width, 480,000 rays a launch:
   `isect_bvh` (the child-pair walk, plain version `traverse_pairs_ref`)
   closest hit on camera rays and on cosine-distributed bounce rays, and
   any hit on shadow rays toward the light, of the 100,012-triangle
   tessellated Cornell box (`tools/time_isect.py: config_a_rays`; ids equal
   on all but 1e-4 of the rays, the share that differs printed, and where
   they differ both t agree to 1e-5 relative; any-hit masks equal on all
   but 1e-4); `isect_brute` on the sets of `tools/time_isect.py:
   brute_sets` (the Cornell box's camera rays, a 64-triangle soup, and
   camera and bounce rays of the 252-triangle box), id, t, u and v equal on
   every ray, once more from arrays that are not 16-byte aligned, the
   sweep's in-line reciprocal against `1.0f / x` on every float it may
   divide by (`isect.rcp_check`), and `isect_brute` on a
   4,096-triangle random soup, so that the table is staged tile by tile,
   under the closest-hit gate above; the plain walks are timed on those
   calls, and the `isect_bvh` launcher must refuse a launch without its ray
   counter;
8. renders config A, the tessellated Cornell box at 800x600, path_mis,
   depth 8, gaussian filter, through `render()` (1-spp warm-up, then 4 spp
   timed with the film on the host), counts the LBVH kernels' and the
   shading kernel's launches in that run (depth x 4 shade, 4 fold), renders bench.py's 400x300 config, prints ptxas' registers and
   spills of both `bvh_kernel` instances, and times closest hit on phase 7's
   camera and bounce rays and any hit on its shadow rays (device time behind
   a spin, median of 7), beside the bound of the parent's skip-link walk on
   the same rays (its nodes and leaves per ray from `traverse_walk_ref`)
   and the pair walk's own count;
9. renders config B, the Cornell box at 800x600 with the mitchell filter,
   path_mis, depth 16, 4 spp, and config B-252, the same with the
   252-triangle tessellated box (`nu=10, nv=7`), counting `isect_brute`'s
   launches in each; prints ptxas' registers and spills of `brute_kernel`
   and the instructions per ray-triangle pair of its sweep loops (SASS,
   `tools/time_isect.py: sweep_loops`), and times it on phase 7's sets
   (device time behind a spin, median of 7; at 12 triangles also the
   kernel alone by torch.profiler) beside each bound, with the launch's
   grid and resident blocks per SM;
10. renders the golden configuration through the general path
   (`mega=False`) and holds it against tests/golden/cbox_{path_mis,path_mats}.exr;
11. holds the path kernel's medium branch (65–8,192 triangles, an LBVH walk
   per bounce) against its plain version on the GPU, rows bit for bit:
   config M's geometry (the tessellated Cornell box at nu=40, nv=51, 8,012
   triangles) at 160x120, box filter, depth 4, 4 spp, path_mis and
   path_mats, and a 70-triangle strip room with a glass
   sphere and a spot light at 64x48, whose LBVH the table packing builds
   (the scene builder makes none below 257 triangles); prints ptxas'
   registers and spills of every kernel instance;
12. renders config M at 800x600, path_mis, depth 16, gaussian filter through
   `render()` (1-spp warm-up, then 16 spp timed with the film on the host),
   counts the launches (the path kernel at least once, no intersection
   kernel: the scene did not take the scan path), times one
   800x600 x 16-spp kernel launch and holds its first 300 rows bit for bit
   against the plain version on the same tables, and
   prints the bound of the LBVH walk (nodes and leaves per ray of config
   M's own camera and bounce rays, from `traverse_walk_ref`, the skip-link
   walk that the medium branch runs) beside the old sweep's;
13. runs the CLI on the GPU on config M's XML at 160x120, 4 spp;
14. runs the two probe entry points (`tools/probe_copy.py`,
   `tools/prof_parts.py`) with their launches counted, holds each probe
   kernel bit for bit against its plain version (`iter_cost` in every mode
   at 64 and 1,024 iterations), checks on which SMs and in which clusters
   their CTAs ran (`probe_copy` in clusters of 8, `iter_cost` `reduce` in
   clusters of 4, the other modes on at least 128 SMs), and prints
   `probe_copy`'s time beside an empty kernel's in its grid and a torch
   yardstick, and `iter_cost` `isect`'s beside its bound at the full and
   the half FP32 rate and the issue limit of its SASS;
15. drives the single-bounce integrators and the surface features through
   the scan path: the Cornell box at 800x600, 4 spp, through `render()`
   once with each of normals, av, direct, direct_ems, direct_mats,
   direct_mis, preview and envmaptester (1-spp warm-up each, film on the
   host inside the clock), checking that the path kernel refuses them and
   that `isect_brute` launched its expected count per sample (1, 2, 2, 2,
   2, 3, 2, 0: one per closest hit or shadow ray of the 480,000-pixel
   chunk) and no LBVH kernel; config T (`scene/presets.py:
   textured_cornell_xml`: checkerboard floor, PNG back wall, normal-mapped
   wall, a sphere light, a rotated EXR envmap) at 800x600, 4 spp, with
   direct_mis and path_mis; config A's geometry with direct_mis (1 spp
   after 1), whose LBVH kernels, closest and any, must launch; and a
   torch.profiler breakdown of one 1-spp Cornell direct_mis render;
16. holds the scan path on the card against tests/golden/cbox_{direct_mis,
   normals}.exr by phase 10's rule, and config T at 64x48, 4 spp, box
   filter (direct_mis and path_mis) on the card against the same render on
   the CPU (median relative error < 1e-4, means within 1e-3);
17. holds the tracking kernel (`csrc/track.cu`: `delta_track`,
   `ratio_track`) bit for bit against its plain versions (the lockstep
   loops of `ops/volume_grid.py`) on the card: t_event / T, K and the four
   pcg32 state words, on config H's 480,000 camera rays into its
   128^3 grid (delta tracking) and on shadow rays from their collision
   points toward the ceiling light (ratio tracking); checks both on a
   constant-density grid against exp(-sigma_t d); prints the kernel's time
   alone (torch.profiler) and behind a spin, the plain version's, the
   bound from the run's sum of K, L, and ptxas' registers / spills;
18. renders config H (`scene/presets.py: medium_cornell_xml`, kind "H":
   the Cornell room with a pass-through box of voxel-grid fog) at
   800x600, depth 8, 1 spp after 1, with path_vol_mis and path_vol_mats,
   and config V (kind "V": a homogeneous Henyey-Greenstein sphere and a
   volume light) with path_vol_mis, through `render()`, asserting the
   exact launch counts (delta_track D*S, ratio_track 8*D*S under
   path_vol_mis and 0 under path_vol_mats, isect_brute 9*D*S / D*S, none
   of the tracking kernels for config V, no path kernel), a torch.profiler
   breakdown of one config H render, and config H through the CLI;
19. renders configs H and V at 64x48, 4 spp, box filter, on the card and
   on the CPU: median relative error < 1e-3, means within 10 %, and the
   pixels over 1e-3 counted;
20. takes the train step (`parallel/shard.py: train_step`) at full width:
   the Cornell box at 800x600, path_mis, depth 16, 1 spp, one 480,000-lane
   `render_round` and one backward, against the same render at radiance x
   0.8; prints the loss, the gradient norms, the seconds of the step, of
   its forward and of its backward apart, the peak memory and the
   launches (`isect_brute` 32 in the forward, none in the backward), a
   torch.profiler breakdown of one step, and the backward of a gather
   from an 8-row table by advanced indexing against `core/math.rows`;
   holds AD against a central difference along a random em_radiance
   direction (h 2e-2, rtol 2e-2), then takes 3 SGD steps on em_radiance,
   and the loss must fall at each; at 64x48, depth 3, on the box with its
   odd diffuse BSDF rows made microfacet, the directional derivative of
   each of the four train_step keys on the card agrees with the CPU's to
   1e-3;
21. takes gradients (em_radiance, and sigma_s with voxel grids) through the
   LBVH walk, the 300-triangle tessellated box (`nu=12, nv=7`) at 800x600,
   path_mis, depth 3, and through the trackers, config H at 800x600,
   path_vol_mis, depth 8: the forward launches `isect_bvh` closest and any
   3 times each, or `isect_brute` 72, `delta_track` 8 and `ratio_track`
   64, the backward none; and at 64x48, depth 3, their directional
   derivatives on the card and on the CPU agree to 1e-3;
22. renders the Cornell box with `<sampler type="adaptive">` at 800x600,
   16 spp, 4 uniform rounds through `render_adaptive` (samples placed,
   rounds, Mpaths/s, `isect_brute` 32 per round) and through the CLI on
   cuda (EXR, PNG and `_variance.exr`), and at 64x48 on the card and on
   the CPU: the same samples placed, median relative error < 1e-4, means
   within 1e-3;
23. renders cell `cornell_pmap_800x600`: the Cornell box with the photon
   mapper at 800x600, depth 16, gaussian filter, 1,000,000 photons at the
   radius the build derives (bbox diagonal / 500), 4 spp after a 1-spp
   warm-up, through `render()`, which builds its photon map inside the
   clock; times the build alone (`render.preprocess`) and the render on a
   built map; asserts `isect_brute` 16 per photon batch and 16 per sample
   (16 x (batches + 4)) and no other kernel; prints the batches, photons
   emitted and stored, the radius, the photons found per gathering lane,
   the peak memory, and a torch.profiler split of a 1-spp render: the
   gather's device time and kernels (against the same render with the
   estimate replaced by zeros), its calls and lanes, and the idle share;
24. renders the photon mapper at depth 8 with 20,000 photons of radius
   0.12 (tests/test_photon.py's configuration) on the card and on the CPU,
   the Cornell box at 48x48 (`isect_brute`) and the 300-triangle box at
   64x48 (`isect_bvh`): stored photons of one batch within 0.1 %, the
   films by the median statistic (< 1e-3, means within 10 %), the exact
   launches;
25. the denoisers: `denoise_bilateral` on phase 23's film on the card and
   the CPU (1e-5 relative); `train-denoiser --size 128 --steps 300
   --clean-spp 256` through the CLI on cuda (its time, the loss must
   halve); the trained net on phase 23's layers at 800x600 on the card (FP32
   convolutions) and the CPU (1e-4 relative to 1 + |out|, the net's
   output being expm1 of its log-space result), both beside a float64
   result, as is the card's default TF32 call, a checkpoint written by the port reloading to the same output, and
   `render --denoise learned` writing `_denoised.exr` / `.png`;
26. runs `cli test --device cuda` on four XMLs it writes: a BSDF t-test
   (diffuse, microfacet at α 0.1 and 0.4, glass; 0, 30, 60 and 80°;
   100,000 samples; references the phase computes: the albedo, a
   Gauss–Legendre integral of f·cos over `eval_bsdf`, F + (1 − F)·η²), a
   χ² test (microfacet α 0.1, resolution 10, testCount 5) and two scene
   t-tests of a furnace whose exact mean is its albedo 0.75, flat-shaded
   spheres of 168 triangles (`isect_brute`, exactly 64 × 2 launches) and
   720 triangles (`isect_bvh` closest and any, 64 each); prints the
   verdicts, means, launches and seconds, and requires rc 0; holds each
   furnace's kernel against its plain version on the test's 100,000
   camera rays and on rays from their hits through the sphere, closest and
   any hit (`isect_brute` equal on every ray, `isect_bvh` by phase 7's
   gates); times the 168-triangle furnace's 100,000 lanes at depth 2
   against 64 (the same radiance: every lane is done after two segments);
   and holds the card against the CPU at sample_scale 0.05 (BSDF means to
   1e-5; each scene lane's luminance, which depends on the face its ray
   hits, to 1e-5 absolute on all but 0.1 % of the lanes; χ² expected tables
   to 1e-5 and observed within 0.1 % of the samples; the same verdicts);
27. runs `warptest --device cuda` (the seven χ² cases must pass) and
   integrates every warp pdf over its domain on the card (within 1e-3 of 1);
28. runs `render --serve --device cuda` on the Cornell box at 800x600,
   path_mis, depth 16, behind its loopback HTTP server: waits for 2
   rounds, times 6 more, POSTs an emitter-radiance edit (`generation`
   bumps, `spp_done` restarts, the frame changes), a bad edit (400),
   pause (the count holds), resume and stop; then `tonemap` on the EXR the
   CLI wrote; prints seconds per round and Mpaths/s, and requires
   `isect_brute` to be the only kernel, 32 launches per round;
29. drives `parallel/shard.py` on two meshes, every visible card
   (`make_mesh()`) and four entries of cuda:0 as (2, 2): `render_sharded`
   of the Cornell box and of config M at 800x600, depth 16, gaussian,
   16 spp (the path kernel over pixel ranges) gives `render()`'s film bit
   for bit with exactly one launch per mesh entry and group; `pathk_trace`
   over pixels [0, 123,457) and [123,457, 480,000) equals one launch's
   rows bit for bit in both branches; config B at 2 spp on the (2, 2)
   mesh (the scan path) is within 2e-4 of `render()` with `isect_brute`
   exactly 2 x 16 x 4; `sharded_train_step` on that mesh against
   `train_step` on both samples of every pixel (loss within 1e-5
   relative, each gradient within 1e-4 of its norm), timed in turns; and
   the 512-spp Cornell bench config through `render_sharded` on every
   card against `render()` (Mpaths/s);
30. starts two `parallel/mh_worker.py` ranks on gloo sharing the card (2
   entries each, a (4, 1) mesh) and holds their film (1e-5), loss and
   gradients (1e-4) against one process's `render()` and `train_step`;
   runs `cli scaling --device cuda` and prints its JSON (with one card the
   efficiency is 1 by construction);
31. holds `isect_spheres` against `traverse_spheres_ref` on a seeded soup
   of 10,000 spheres, 480,000 camera rays and shadow rays from their hits
   (phase 7's gates), prints its time behind a spin (the row's time) and
   alone (torch.profiler) beside its bound (the kernel's pair rows and leaves per ray) and
   ptxas' registers and spills of every `bvh_kernel` instance; renders an
   80-sphere Cornell scene (`sphere_cornell_xml`) at 800x600, depth 8,
   4 spp through `render()` with `isect_spheres` closest and any exactly
   8 x 4 each, and at 64x48 on the card against the CPU (median
   relative error < 1e-3, means within 10 %);
32. renders by path regeneration (`render/wavefront.py: render_wavefront`,
   2^19 lanes) bit for bit the scan path's paths with the box filter (every
   splatted position and its layers) and its films on every pixel of at
   most two samples: the Cornell box at 800x600, depth 16, 2 spp,
   `path_mis` and `path_mats` (`isect_brute` exactly 2 and 1 per
   iteration), config A at depth 8, 1 spp (`isect_bvh` closest and any 1
   each per iteration), counting the iterations by wrapping
   `wavefront_iter`; then times in turns config B
   (scan path against wavefront) and the gaussian Cornell at 16 spp (the
   path kernel against wavefront), with Mpaths/s, iterations per sample,
   segments per path, idle iterations at the end, config B's peak memory
   and a trace of each (kernels, idle share), and one masked mitchell
   splat over the pool;
33. builds LBVHs on the card (`ops/bvh.py: build_bvh` / `build_sphere_bvh`
   on CUDA: the chain of `csrc/lbvh.cu`) and holds `packed`, `leaf`,
   `pairs` and `depth` bit for bit against the numpy twin (the port's
   host builder) on 1, 3, 4, 257, 1,000 and 4,097 triangles, config A's
   100,012, a 1,000-triangle soup of equal centroids, soups of 1,000,000
   and 4,000,000 triangles with +0 / -0 coordinates and repeated
   centroids, and 65, 10,000 and the 80 spheres of `sphere_cornell_xml`;
   times the chain (CUDA events, median of 5), its two `torch.sort` calls
   apart on as many keys, and its kernels (torch.profiler) at 100,012, 1M
   and 4M triangles and 10,000 spheres beside the twin's host build plus
   upload and the bytes bound; loads
   config A with `device="cuda"` and `device="cpu"` in turns (one build
   chain; every tensor bit-equal), times the `scene.to(cuda)` that
   `render()` made of a host-built config A and H, and renders config A at
   phase 8's settings from the card-built scene (launches equal to phase
   8's) against the host-built one (median statistic), load + render
   timed in turns;
34. holds the scan path's shading kernel (`csrc/scan.cu: shade_kernel`,
   through `integrators/path.py: li_path_fused`) against the torch chain
   (`li_path_mis` / `li_path_mats`) on the 480,000 camera rays of config A
   (depth 8) and config B (depth 16) at 800x600: L, albedo and normal
   within 1e-4 x (|chain| + 1e-3) outside at most 0.1 % of lanes, and
   after each bounce the pcg32 state of every live lane equal; times the
   kernel (torch.profiler) and its plain version `shade_ref` (CUDA events)
   per launch beside the kernel's bytes bound;
35. holds the scan path's filter splat (`csrc/film.cu: splat_kernel`,
   through `render/film.py: splat_`) against its plain body
   (`_splat_plain_`) on one real round of config A (gaussian) and config B
   (mitchell) at 800x600, as `render.scan_step` chunks it: the films within the
   tolerance of two orders of adds; times the kernel (torch.profiler) and
   the plain body (CUDA events) per round beside the kernel's bytes bound (the
   kernel by CUDA events where the profiler records none of its launches);
   holds its adjoint (`splat_grad_kernel`, the backward of a card's `splat`)
   against the plain body's autograd on a random film gradient and times it
   (CUDA events) beside its bytes bound.

Every scene a phase renders on the card is built there
(`load_scene(..., device)`, the presets' `device=`).

Every phase prints its seconds and raises on failure. The second-to-last line is a JSON object with
each kernel's route, source, launches, error, times and bound; the last line
is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import math
import re
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch

from optix_renderer_tpu_torch.utils import tracing

# the published H100 SXM peaks, the FP32 operations of one Moller-Trumbore
# test and of a ray's direction reciprocal, and the bytes an intersection
# call must move per ray (o, d, mint, cutoff in; id, t, u, v out)
from optix_renderer_tpu_torch.tools.time_isect import (
    OPS_MT,
    OPS_RAY,
    PEAK_BYTES,
    PEAK_FP32,
    RAY_BYTES,
)

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "optix_renderer_tpu_torch/csrc/pathk.cu"
REPLACES = "optix_renderer_tpu/ops/pallas/pathk.py:992"
ISECT_SOURCE = "optix_renderer_tpu_torch/csrc/isect.cu"
PROBES_SOURCE = "optix_renderer_tpu_torch/csrc/probes.cu"
# FP32 operations counted from csrc/isect.cu (and csrc/pathk.cu, mega.cuh):
# one slab test of a node, one pair row (two slab tests and the
# nearer-child compare), one sphere test
OPS_SLAB = 25
OPS_PAIR = 2 * OPS_SLAB + 1
OPS_SPHERE = 39
# rows of config M's 800x600 launch that phase 12 holds against the plain
# version (its LBVH walk took 65-122 s for the 300 on an H100)
M_REF_ROWS = 300
TRACK_SOURCE = "optix_renderer_tpu_torch/csrc/track.cu"
# FP32 operations of one tracking step (csrc/track.cu: walk_lane's loop
# body and density): the free flight 5, its escape test 1, the point 6, the
# lookup 65 (box-relative coordinates 12, index coordinates 6, floor 3,
# fractions 3, 1 - w 3, weights 16, products 8, sum 7, bbox test 6, scale
# 1), the real / null test 3 (ratio tracking: the factor and the cut, 6);
# and per lane the setup, the bbox clip and majorant (~40)
OPS_STEP = 80
OPS_LANE = 40
# bytes one lane moves once: ro, rd, t_max, med, four state words in;
# t_event / T, K, two state words out
LANE_BYTES = 12 + 12 + 4 + 4 + 32 + 4 + 4 + 16
# the kernels whose launch counters (`launch.<kernel>`, utils/tracing.py)
# the render phases read
ISECT_KERNELS = ("isect_bvh_closest", "isect_bvh_any", "isect_brute", "isect_spheres_closest",
                 "isect_spheres_any")
KERNELS = (*ISECT_KERNELS, "delta_track", "ratio_track", "pathk")
# the scan path's shading kernel: a bounce's shade launch, the last fold
SCAN_KERNELS = ("scan_shade", "scan_fold")


_last_phase = [time.time()]


def launches_of(kernels) -> dict[str, int]:
    """{kernel: its launches since its counter was last reset}."""
    return {k: tracing.counter(f"launch.{k}") for k in kernels}


def phase(n: int, msg: str) -> None:
    now = time.time()
    print(f"[phase {n}] {msg} ({now - _last_phase[0]:.1f} s)", flush=True)
    _last_phase[0] = now


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


def strip_room_xml(tmp: Path) -> Path:
    """A floor + back-wall room with the 66-triangle strip of
    tests/test_torch_medium.py (70 triangles in all), a glass sphere and a
    spot light."""
    from optix_renderer_tpu_torch.scene.presets import write_quad_obj

    write_quad_obj(tmp, "floor", [(-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)])
    write_quad_obj(tmp, "back", [(-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)])
    verts = [f"v {x} 0.25 {-1.0 + 0.1 * k}" for k in range(34) for x in (-1.0, 1.0)]
    faces = [f"f {2 * k + 1} {2 * k + 3} {2 * k + 4} {2 * k + 2}" for k in range(33)]
    (tmp / "strip.obj").write_text("\n".join(verts + faces) + "\n")
    xml = tmp / "strip_room.xml"
    xml.write_text(
        '<scene><integrator type="path_mis"/><camera type="perspective">'
        '<integer name="width" value="64"/><integer name="height" value="48"/>'
        '<float name="fov" value="40"/><transform name="toWorld">'
        '<lookat origin="0 1.0 4.3" target="0 1.0 0" up="0 1 0"/></transform></camera>'
        '<shape type="obj"><string name="filename" value="floor.obj"/><bsdf type="diffuse"/></shape>'
        '<shape type="obj"><string name="filename" value="back.obj"/><bsdf type="diffuse"/></shape>'
        '<shape type="obj"><string name="filename" value="strip.obj"/></shape>'
        '<shape type="sphere"><point name="center" value="0.2 0.6 0.1"/>'
        '<float name="radius" value="0.3"/><bsdf type="dielectric"/></shape>'
        '<emitter type="spot"><point name="position" value="0 1.8 1"/>'
        '<vector name="direction" value="0 -1 -0.5"/><color name="power" value="60 50 40"/>'
        '<float name="falloffstart" value="15"/><float name="totalwidth" value="30"/></emitter>'
        "</scene>")
    return xml


def golden_stats(out, ref) -> dict:
    """tests/test_golden.py's statistic, max |a−b|/(|ref|+1e-2), with the
    pixels over 1e-3, the median and the means."""
    err = (np.abs(out - ref) / (np.abs(ref) + 1e-2)).max(axis=-1)
    return {"max": float(err.max()), "median": float(np.median(err)),
            "pixels_over_1e-3": int((err > 1e-3).sum()),
            "mean": float(out.mean()), "mean_ref": float(ref.mean())}


def hold_golden(integ: str, dev) -> dict:
    """tools/gen_golden.py's config through the scan path on `dev`, held
    against tests/golden/cbox_{integ}.exr: tests/test_golden.py's bound, or,
    where a sample of the 8 x 3072 takes another branch than in the JAX
    film, every pixel over it inside two filter footprints, the median
    < 1e-4 and the means within 1e-3 (tests/test_torch_general.py)."""
    from optix_renderer_tpu_torch.render.film import in_footprints
    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.scene.presets import make_cornell_box
    from optix_renderer_tpu_torch.utils.imageio import read_exr

    scene, cfg, _ = make_cornell_box(64, 48, 1, integ, device=dev)
    cfg = dataclasses.replace(cfg, max_depth=4, rfilter="gaussian")
    b = render(scene, cfg, sample_count=8, device=dev, mega=False)["composite"]
    a = read_exr(ROOT / "tests" / "golden" / f"cbox_{integ}.exr")[..., :3]
    st = golden_stats(b, a)
    print(f"  golden {integ} through the scan path: {json.dumps(st)}")
    over = (np.abs(b - a) / (np.abs(a) + 1e-2)).max(axis=-1) > 1e-3
    ok = st["max"] < 1e-3 or (st["median"] < 1e-4 and in_footprints(over, cfg.rfilter, 2)
                               and abs(st["mean"] - st["mean_ref"]) <= 1e-3 * st["mean_ref"])
    if not ok:
        raise AssertionError(f"golden {integ} through the scan path: {st}")
    return st


def device_breakdown(fn, top: int = 8, sums: tuple = ()) -> dict:
    """Wall clock of `fn()` under torch.profiler, the device's busy time (its
    CUDA kernels' self time: each CPU op's row repeats its kernels' time, so
    only the CUDA events are summed), their count, the idle share, the
    `top` kernels by device time (ms) and, per name fragment of `sums`, the
    device ms of the kernels whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        wall = time.time() - t0
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e6
    ev.sort(key=lambda e: -e.self_device_time_total)
    return {"wall_s": wall, "device_busy_s": busy, "kernels": sum(e.count for e in ev),
            "idle_share": 1.0 - busy / wall,
            "top_ms": {e.key[:50]: e.self_device_time_total / 1e3 for e in ev[:top]},
            **{f"{frag}_ms": sum(e.self_device_time_total for e in ev if frag in e.key) / 1e3
               for frag in sums}}


def device_trace(fn, sums: tuple = ()) -> dict:
    """`device_breakdown`'s wall, busy time, event count and idle share of
    `fn()`, from the CUDA activity alone, read from the profiler's raw
    events: a step of 300,000 kernels traces in seconds where
    `key_averages()` over its CPU ops takes minutes. Per name fragment of
    `sums`, the device ms and count of the events whose name holds it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    ev = [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
          if e.device_type() == DeviceType.CUDA]
    busy = sum(d for _, d in ev) / 1e9
    return {"wall_s": wall, "device_busy_s": busy, "kernels": len(ev),
            "idle_share": 1.0 - busy / wall,
            **{f"{frag}_ms": sum(d for n, d in ev if frag in n) / 1e6 for frag in sums},
            **{f"{frag}_count": sum(1 for n, _ in ev if frag in n) for frag in sums}}


# ---- phases 26-28: the front end (cli test, warptest, the live view)

# the scene-mode t-tests' integrator depth (validation/xmltest.py raises the
# scene's depth to at least 64) and their path_mis intersection calls per
# bounce: the closest hit and NEE's shadow ray
TTEST_DEPTH = 64
TTEST_CALLS_PER_BOUNCE = 2


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def fresnel(cos_i: float, ext: float, int_: float) -> float:
    """Unpolarized dielectric reflectance from outside, in float64."""
    eta = ext / int_
    cos_t = math.sqrt(1.0 - eta * eta * (1.0 - cos_i * cos_i))
    rs = (ext * cos_i - int_ * cos_t) / (ext * cos_i + int_ * cos_t)
    rp = (int_ * cos_i - ext * cos_t) / (int_ * cos_i + ext * cos_t)
    return 0.5 * (rs * rs + rp * rp)


def bsdf_references(bsdf_xml, angles, dev) -> list:
    """The mean sample luminance, ∫ f·cosθo dωo, of each BSDF at each angle:
    a gray diffuse albedo is its own; glass F + (1 − F)·(intIOR / extIOR)²
    (reflection weighs 1, refraction 1/η²); a microfacet by the
    Gauss–Legendre rule of `validation/xmltest.py: _gl_cell_integrals` on
    20 × 40 cells over `eval_bsdf` on `dev`, summed in float64."""
    from optix_renderer_tpu_torch.ops import bsdf as bsdf_ops
    from optix_renderer_tpu_torch.scene.build import build_bsdf_table
    from optix_renderer_tpu_torch.scene.parser import load_from_string
    from optix_renderer_tpu_torch.validation.xmltest import _LUM, _gl_cell_integrals

    nodes = [load_from_string(x) for x in bsdf_xml]
    bsdfs, tex = (t.to(dev) for t in build_bsdf_table(nodes))
    refs = []
    for bi, node in enumerate(nodes):
        for angle in angles:
            th = math.radians(angle)
            if node.type == "diffuse":
                refs.append(float(node.props.get_color("albedo").astype(np.float64) @ _LUM))
            elif node.type == "dielectric":
                ext, int_ = (node.props.get_float("extIOR", 1.000277),
                             node.props.get_float("intIOR", 1.5046))
                f = fresnel(math.cos(th), ext, int_)
                refs.append(f + (1.0 - f) * (int_ / ext) ** 2)
            else:
                wi = torch.tensor([math.sin(th), 0.0, math.cos(th)], device=dev)

                def f_cos(dirs, bi=bi, wi=wi):
                    m = torch.from_numpy(dirs.reshape(-1, 3).astype(np.float32)).to(dev)
                    k = m.shape[0]
                    f = bsdf_ops.eval_bsdf(bsdfs, tex, torch.full((k,), bi, dtype=torch.int32,
                                                                  device=dev),
                                           wi.expand(k, 3), m, torch.zeros((k, 2), device=dev))
                    lum = f.cpu().numpy().astype(np.float64) @ _LUM
                    return (lum * np.abs(dirs.reshape(-1, 3)[:, 2])).reshape(dirs.shape[:-1])

                refs.append(float(_gl_cell_integrals(f_cos, 20, 40).sum()))
    return refs


def _captured(fn) -> tuple:
    """(fn(), what it printed, its seconds)."""
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue(), time.time() - t0


def pdf_integrals(dev) -> dict:
    """∫ pdf over its domain, on `dev`, for each pdf `warptest` and the JAX
    `core/warp.py` name: a midpoint rule on 900 × 450 (θ, φ) cells (θ = π/3
    and π/2 on cell edges), and on 800 × 800 cells of the plane for the
    square and the disk."""
    from optix_renderer_tpu_torch.core import warp

    n = 450
    t = (np.arange(n) + 0.5) * np.pi / n
    tt, pp = np.meshgrid(t, (np.arange(2 * n) + 0.5) * np.pi / n, indexing="ij")
    dirs = torch.from_numpy(np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                                      np.cos(tt)], -1).reshape(-1, 3).astype(np.float32)).to(dev)
    dw = (np.sin(tt) * (np.pi / n) ** 2).reshape(-1)

    def on_sphere(v):
        return float(v.double().cpu().numpy() @ dw)

    def on_plane(fn, lo, hi, m=800):
        x = lo + (np.arange(m) + 0.5) * (hi - lo) / m
        xx, yy = np.meshgrid(x, x, indexing="ij")
        p = torch.from_numpy(np.stack([xx, yy], -1).reshape(-1, 2).astype(np.float32)).to(dev)
        return float(fn(p).double().sum().cpu()) * ((hi - lo) / m) ** 2

    half = torch.tensor(0.5, device=dev)
    return {
        "uniform_square": on_plane(warp.square_to_uniform_square_pdf, -0.5, 1.5),
        "uniform_disk": on_plane(warp.square_to_uniform_disk_pdf, -1.5, 1.5),
        "uniform_sphere": on_sphere(warp.square_to_uniform_sphere_pdf(dirs)),
        "sphere_cap c=0.5": on_sphere(warp.square_to_uniform_sphere_cap_pdf(dirs, 0.5)),
        "uniform_hemisphere": on_sphere(warp.square_to_uniform_hemisphere_pdf(dirs)),
        "cosine_hemisphere": on_sphere(warp.square_to_cosine_hemisphere_pdf(dirs)),
        "beckmann a=0.3": on_sphere(warp.square_to_beckmann_pdf(dirs, 0.3)),
        "hg g=0.5": on_sphere(warp.square_to_henyey_greenstein_pdf(dirs, half)),
        "schlick k=0.5": on_sphere(warp.square_to_schlick_pdf(dirs, half)),
    }


def _http(port: int, path: str, body: bytes | None = None) -> bytes:
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="GET" if body is None else "POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read()


def _status(port: int) -> dict:
    return json.loads(_http(port, "/status"))


def _wait_status(port: int, cond, timeout: float = 300.0) -> tuple:
    """(status, time.time()) at the first poll, every 100 ms, where
    cond(status) holds; connection errors while the server starts are
    retried. Each poll takes the interpreter lock from the render loop, a
    host-bound launcher, so the cadence is a busy page's, not a tight loop."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            st = _status(port)
        except urllib.error.URLError:
            time.sleep(0.1)
            continue
        if cond(st):
            return st, time.time()
        time.sleep(0.1)
    raise AssertionError(f"live view: timed out waiting on port {port}")


def furnace_holds(xml: Path, n: int, dev) -> float:
    """Hold the intersection kernel that a furnace t-test launches against
    its plain version on the card, at the test's width: its `n` camera rays,
    drawn as `validation/xmltest.py: _scene_luminances` draws them, and from
    their hits `n` rays in uniform directions (half cross the sphere to its
    far side), closest hit and, cut at a uniform distance below the
    diameter 2, any hit. `isect_brute` must equal `mt_sweep_ref` (id, t, u,
    v) on every ray; `isect_bvh` is held by phase 7's gates against
    `traverse_pairs_ref`. Returns max |t_kernel - t_plain|."""
    from optix_renderer_tpu_torch.ops import bvh as bvh_ops
    from optix_renderer_tpu_torch.ops import camera as cam_ops
    from optix_renderer_tpu_torch.ops.cuda import isect
    from optix_renderer_tpu_torch.scene.build import build_scene
    from optix_renderer_tpu_torch.scene.parser import load_from_xml

    sn = load_from_xml(xml).children_of("scene")[0]
    sn.origin = str(xml.parent)
    scene, cfg, _ = build_scene(sn, dev)
    geom = scene.geometry

    def f32(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    rng = np.random.default_rng(0)  # the draws of the test's scene 0
    pix = rng.random((n, 2)) * np.array([cfg.width, cfg.height])
    ray, _ = cam_ops.sample_ray(scene.camera, cfg.width, cfg.height, f32(pix),
                                f32(rng.random((n, 2))))
    camera = (ray.o, ray.d, ray.mint, torch.where(torch.isinf(ray.maxt), bvh_ops.BIG, ray.maxt))
    brute = cfg.n_tris < bvh_ops.MIN_TRIS_FOR_BVH
    tri, tree = geom.tri_table, geom.bvh
    if brute:
        def plain(*r, any_hit=False):
            return isect.mt_sweep_ref(*r, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
    else:
        def plain(*r, any_hit=False):
            return bvh_ops.traverse_pairs_ref(tree.pairs, tree.leaf, *r, any_hit=any_hit)
    first = plain(*camera)
    p = camera[0] + camera[1] * torch.where(first[0] >= 0, first[1], 0.0)[:, None]
    d = torch.nn.functional.normalize(f32(rng.normal(size=(n, 3))), dim=-1)
    mint = torch.full((n,), 1e-4, device=dev)
    sets = {"camera rays": (camera, False), "rays through the sphere": (
        (p, d, mint, torch.full((n,), bvh_ops.BIG, device=dev)), False),
        "cut rays through the sphere, any hit": ((p, d, mint, f32(rng.uniform(0.0, 2.0, n))),
                                                 True)}
    err = 0.0
    for what, (rays, any_hit) in sets.items():
        ref = first if what == "camera rays" else plain(*rays, any_hit=any_hit)
        what = f"furnace {cfg.n_tris} triangles, {what}"
        if brute:
            got = isect.isect_brute(tri, *rays)
            _sync(dev)
            bad = [int((a != b).sum()) for a, b in zip(got, ref)]
            print(f"  isect_brute, {what}: {n} rays, hits {float((ref[0] >= 0).float().mean()):.4f}"
                  f", rays whose id, t, u, v differ from the plain version {bad}", flush=True)
            if any(bad):
                raise AssertionError(f"isect_brute, {what}: differs from mt_sweep_ref on {bad}")
            err = max(err, float((got[1] - ref[1]).abs().max()))
        else:
            got = isect.isect_bvh(tree, *rays, any_hit=any_hit)
            gate = gate_any if any_hit else gate_closest
            err = max(err, gate(f"isect_bvh, {what}", got, ref))
    if not bool((first[0] >= 0).all()):
        raise AssertionError("a furnace camera ray missed the sphere")
    return err


def front_end(dev, smi: str, reset_counts, read_counts) -> dict:
    """Phases 26-28 on `dev`; returns each phase's record, launches included."""
    from optix_renderer_tpu_torch import cli
    from optix_renderer_tpu_torch.integrators import get_integrator
    from optix_renderer_tpu_torch.ops import camera as cam_ops
    from optix_renderer_tpu_torch.render import sampler as smp
    from optix_renderer_tpu_torch.scene import presets
    from optix_renderer_tpu_torch.scene.build import build_scene
    from optix_renderer_tpu_torch.scene.parser import load_from_xml
    from optix_renderer_tpu_torch.utils.imageio import read_exr, read_png
    from optix_renderer_tpu_torch.validation import run_xml_test

    rec = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_front_") as tmp:
        # ---- 26. cli test on the card: BSDF t-test, χ² test, scene t-tests
        angles = (0.0, 30.0, 60.0, 80.0)
        refs = bsdf_references(presets.TTEST_BSDFS, angles, dev)
        xmls = {
            "ttest_bsdf": presets.test_xml(
                tmp, "ttest_bsdf.xml", "ttest",
                {"angles": ", ".join(map(str, angles)),
                 "references": ", ".join(f"{r:.7f}" for r in refs), "sampleCount": 100_000},
                presets.TTEST_BSDFS),
            "chi2_microfacet": presets.test_xml(
                tmp, "chi2.xml", "chi2test", {"resolution": 10, "testCount": 5},
                presets.TTEST_BSDFS[1:2]),
            # the exact mean luminance of both furnaces is the albedo 0.75;
            # 168 triangles take the brute-force sweep, 720 the LBVH walk
            "furnace_brute": presets.test_xml(
                tmp, "furnace_brute.xml", "ttest", {"references": "0.75", "sampleCount": 100_000},
                [presets.furnace_scene(tmp, nu=12, nv=8)]),
            "furnace_bvh": presets.test_xml(
                tmp, "furnace_bvh.xml", "ttest", {"references": "0.75", "sampleCount": 100_000},
                [presets.furnace_scene(tmp, nu=24, nv=16)]),
        }
        want_launches = {
            "ttest_bsdf": {}, "chi2_microfacet": {},
            "furnace_brute": {"isect_brute": TTEST_DEPTH * TTEST_CALLS_PER_BOUNCE},
            "furnace_bvh": {"isect_bvh_closest": TTEST_DEPTH, "isect_bvh_any": TTEST_DEPTH}}
        tests = {}
        for name, xml in xmls.items():
            reset_counts()
            rc, out, secs = _captured(lambda: cli.main(["test", str(xml), "--device",
                                                         str(dev.type)]))
            ln = {k: v for k, v in read_counts().items() if v}
            means = [float(m) for m in re.findall(r"mean=([0-9.eE+-]+)", out)]
            tests[name] = {"rc": rc, "s": secs, "launches": ln, "means": means,
                           "verdicts": re.findall(r"\[(PASS|FAIL)\]", out),
                           "passed": re.findall(r"Passed \d+/\d+ tests.", out)}
            print(f"  cli test {name} on {dev.type}, on {smi}: {json.dumps(tests[name])}",
                  flush=True)
            print("    " + "\n    ".join(out.strip().splitlines()), flush=True)
            if rc != 0 or ln != want_launches[name]:
                raise AssertionError(f"cli test {name}: rc {rc}, launches {ln}, expected "
                                     f"{want_launches[name]}")
        # each furnace's kernel against its plain version on the test's
        # 100,000 lanes
        holds = {name: furnace_holds(xmls[name], 100_000, dev)
                 for name in ("furnace_brute", "furnace_bvh")}
        # the furnace's lanes are all done after two segments (a convex
        # mesh): the same 100,000 lanes at depth 64 and at depth 2 give
        # the same luminance; the time the other 62 bounces take
        sn = load_from_xml(xmls["furnace_brute"]).children_of("scene")[0]
        sn.origin = str(tmp)
        scene_f, cfg_f, _ = build_scene(sn, dev)
        r_ = np.random.default_rng(0)
        n_f = 100_000
        pix = torch.from_numpy((r_.random((n_f, 2)) * [cfg_f.width, cfg_f.height]).astype(
            np.float32)).to(dev)
        ray, wgt = cam_ops.sample_ray(scene_f.camera, cfg_f.width, cfg_f.height, pix,
                                      torch.from_numpy(r_.random((n_f, 2)).astype(np.float32)).to(
                                          dev))
        depth_runs = {}
        for depth in (2, TTEST_DEPTH):
            cfg_d = dataclasses.replace(cfg_f, max_depth=depth)
            li = get_integrator(cfg_d.integrator)
            s = smp.make_sampler(torch.arange(n_f, device=dev), 0)
            li(scene_f, cfg_d, ray, s)  # warm-up
            reset_counts()
            _sync(dev)
            t0 = time.time()
            L = li(scene_f, cfg_d, ray, s)[0]
            _sync(dev)
            depth_runs[depth] = {"s": time.time() - t0, "launches": {
                k: v for k, v in read_counts().items() if v},
                "L": (L * wgt).double().cpu().numpy()}
        # a lane that leaves the sphere at a grazing angle from a point that
        # rounds inside it can meet the sphere again; at most 1e-4 of them
        differ = int((depth_runs[2]["L"] != depth_runs[TTEST_DEPTH]["L"]).any(axis=-1).sum())
        dead = {"depth2_s": depth_runs[2]["s"], "depth64_s": depth_runs[TTEST_DEPTH]["s"],
                "depth2_launches": depth_runs[2]["launches"],
                "depth64_launches": depth_runs[TTEST_DEPTH]["launches"],
                "lanes_differing": differ}
        print(f"  furnace 168 triangles, 100,000 lanes, path_mis at depth 2 and 64 on {smi}: "
              f"{json.dumps(dead)}", flush=True)
        if differ > 1e-4 * n_f:
            raise AssertionError(f"the furnace's radiance differs between depth 2 and 64 on "
                                 f"{differ} lanes")
        # the card against the CPU at sample_scale 0.05, the same samples
        scale = 0.05
        vs_cpu = {}
        for name, xml in xmls.items():
            a = run_xml_test(xml, verbose=False, sample_scale=scale, device=dev)
            b = run_xml_test(xml, verbose=False, sample_scale=scale, device="cpu")
            row = {"verdicts_equal": [m.split("]")[0] for m in a.messages]
                   == [m.split("]")[0] for m in b.messages]}
            if "chi2" in name:
                row["observed_abs_diff"] = max(float(np.abs(x["observed"] - y["observed"]).sum())
                                               for x, y in zip(a.details, b.details))
                row["expected_max_rel"] = max(float(np.max(
                    np.abs(x["expected"] - y["expected"]) / np.maximum(y["expected"], 1e-300)))
                    for x, y in zip(a.details, b.details))
                ok = row["observed_abs_diff"] <= 1e-3 * a.details[0]["observed"].sum() and \
                    row["expected_max_rel"] <= 1e-5
            elif name == "ttest_bsdf":
                # BSDF samples to float32 rounding
                row["mean_max_rel"] = max(abs(x["mean"] - y["mean"]) / abs(y["mean"])
                                          for x, y in zip(a.details, b.details))
                ok = row["mean_max_rel"] <= 1e-5
            else:
                # every lane's luminance (~0.75, set by the face its ray
                # hits) within 1e-5 absolute on all but 0.1 % of the lanes
                # (the rule of tests/test_torch_simple.py): a hit point
                # can round one ulp apart on the two devices, and a
                # grazing shadow ray from it then meets its own face on
                # one of them only (1 lane of 5,000 in the 720-triangle
                # furnace on an H100), while a kernel that returns a
                # neighbouring face moves a quarter of them (on the CPU)
                diff = np.abs(a.details[0]["lum"] - b.details[0]["lum"])
                row.update(lanes=int(diff.size), lane_max_abs=float(diff.max()),
                           lanes_over_1e_5=int((diff > 1e-5).sum()),
                           mean_rel=abs(a.details[0]["mean"] - b.details[0]["mean"])
                           / b.details[0]["mean"])
                ok = row["lanes_over_1e_5"] <= 1e-3 * diff.size
            vs_cpu[name] = row
            print(f"  cli test {name} at sample_scale {scale}, {dev.type} against cpu: "
                  f"{json.dumps(row)}", flush=True)
            if not (ok and row["verdicts_equal"]):
                raise AssertionError(f"cli test {name}: the card differs from the CPU: {row}")
        rec[26] = {"tests": tests, "kernel_max_abs_err": holds, "dead_lanes": dead,
                   "vs_cpu": vs_cpu}
        phase(26, f"cli test on {dev.type}: {sum(t['rc'] == 0 for t in tests.values())}/"
                  f"{len(tests)} passed; furnace launches {tests['furnace_brute']['launches']} "
                  f"and {tests['furnace_bvh']['launches']}; the kernels match their plain "
                  f"versions on the tests' rays and the card's lanes the cpu's")

        # ---- 27. warptest on the card, and the pdfs integrate to 1
        rc, out, secs = _captured(lambda: cli.main(["warptest", "--device", str(dev.type)]))
        lines = [ln for ln in out.splitlines() if ln.strip()]
        print("    " + "\n    ".join(lines), flush=True)
        integrals = pdf_integrals(dev)
        worst = max(abs(v - 1.0) for v in integrals.values())
        rec[27] = {"rc": rc, "s": secs, "passed": sum(ln.startswith("PASS") for ln in lines),
                   "pdf_integrals": integrals, "max_abs_err": worst}
        print(f"  warptest and pdf integrals on {dev.type}, on {smi}: {json.dumps(rec[27])}",
              flush=True)
        if rc != 0 or rec[27]["passed"] != 7 or len(lines) != 7 or not worst <= 1e-3:
            raise AssertionError(f"warptest: {rec[27]}")
        phase(27, f"warptest on {dev.type}: 7/7 passed in {secs:.2f} s; the pdfs integrate to 1 "
                  f"within {worst:.2e}")

        # ---- 28. render --serve: the live view of the Cornell box at 800x600,
        # path_mis, depth 16, behind a loopback HTTP server
        w, h = 800, 600
        xml = presets.cornell_box_xml(tmp, w, h, 1_000_000, "path_mis")
        base = Path(tmp) / "live"
        with socket.socket() as s_:
            s_.bind(("127.0.0.1", 0))
            port = s_.getsockname()[1]
        rc_serve = []
        reset_counts()
        t_start = time.time()
        srv = threading.Thread(target=lambda: rc_serve.append(cli.main(
            ["render", str(xml), "--serve", "--port", str(port), "--device", str(dev.type),
             "--depth", "16", "-o", str(base)])), daemon=True)
        srv.start()
        try:
            st_a, t_a = _wait_status(port, lambda s: s["spp_done"] >= 2)
            first_s = t_a - t_start
            st_b, t_b = _wait_status(port, lambda s: s["spp_done"] >= st_a["spp_done"] + 6)
            rounds = st_b["spp_done"] - st_a["spp_done"]
            s_round = (t_b - t_a) / rounds
            frame0 = _http(port, "/frame")
            page = _http(port, "/")
            if frame0[:8] != b"\x89PNG\r\n\x1a\n" or b"live view" not in page:
                raise AssertionError("live view: no PNG frame or page")
            before = _status(port)["spp_done"]
            ok_edit = _http(port, "/edit", json.dumps(
                {"kind": "emitter_radiance", "index": 0, "value": [40.0, 2.0, 2.0]}).encode())
            st_e, _ = _wait_status(port, lambda s: s["generation"] == 1)
            restarted = st_e["spp_done"] < before
            st_e2, _ = _wait_status(port, lambda s: s["generation"] == 1 and s["spp_done"] >= 2)
            frame1 = _http(port, "/frame")
            try:
                _http(port, "/edit", b'{"kind": "nope", "index": 0, "value": [1]}')
                bad_refused = False
            except urllib.error.HTTPError as e:
                bad_refused = e.code == 400
            _http(port, "/control", b"pause")
            st_p, _ = _wait_status(port, lambda s: s["status"] == "paused")
            time.sleep(1.0)
            held = _status(port)["spp_done"] == st_p["spp_done"]
            _http(port, "/control", b"resume")
            _wait_status(port, lambda s: s["spp_done"] > st_p["spp_done"])
        finally:
            try:
                _http(port, "/control", b"stop")
            except urllib.error.URLError:
                pass
            srv.join(timeout=300)
        ln = {k: v for k, v in read_counts().items() if v}
        img = read_exr(str(base) + ".exr")
        rc_t, _, _ = _captured(lambda: cli.main(["tonemap", str(base) + ".exr", "--exposure",
                                                 "0.5"]))
        png = read_png(str(base) + ".png")
        mpaths = w * h / s_round / 1e6
        # where a round's time goes: the render round alone (one chunk of
        # w·h lanes), then the frame the loop publishes (one layer to the
        # host, encoded as PNG), and on the card a profile of one round
        from optix_renderer_tpu_torch.render import film as film_ops
        from optix_renderer_tpu_torch.render import scan_graph
        from optix_renderer_tpu_torch.render.render import render_round_accumulate
        from optix_renderer_tpu_torch.scene.build import load_scene
        from optix_renderer_tpu_torch.utils.imageio import encode_png

        scene_l, cfg_l, _ = load_scene(xml, dev)
        cfg_l = dataclasses.replace(cfg_l, max_depth=16)
        ids = torch.arange(w * h, device=dev)
        acc = torch.zeros((3, h, w, 4), device=dev)
        sc_l = scan_graph.shade_scene(scene_l, cfg_l, dev)
        render_round_accumulate(acc, scene_l, cfg_l, ids, 0, sc_l)
        _sync(dev)
        t0 = time.time()
        render_round_accumulate(acc, scene_l, cfg_l, ids, 1, sc_l)
        _sync(dev)
        round_only_s = time.time() - t0
        t0 = time.time()
        encode_png(film_ops.to_bitmap(acc[0]).cpu().numpy())
        publish_s = time.time() - t0
        prof = device_breakdown(lambda: (render_round_accumulate(acc, scene_l, cfg_l, ids, 2, sc_l),
                                         _sync(dev)), top=4)
        rec[28] = {"size": f"{w}x{h}", "first_round_ready_s": first_s, "s_per_round": s_round,
                   "round_alone_s": round_only_s, "publish_s": publish_s, "profile_round": prof,
                   "rounds_timed": rounds, "mpaths_s": mpaths, "edit": ok_edit.decode(),
                   "generation": st_e["generation"], "spp_before_edit": before,
                   "spp_at_generation_1": st_e["spp_done"], "restarted": restarted,
                   "frame_changed": frame1 != frame0, "bad_edit_refused": bad_refused,
                   "pause_held": held, "rc": rc_serve, "launches": ln,
                   "exr_mean": float(img.mean()), "tonemap_rc": rc_t}
        print(f"  live view, Cornell {w}x{h}, path_mis, depth 16, on {dev.type}: "
              f"{s_round:.4f} s per round, {mpaths:.4f} Mpaths/s on {smi}; "
              f"{json.dumps(rec[28])}", flush=True)
        per_round = 16 * 2  # path_mis: the closest hit and NEE's shadow ray per bounce
        if not (rc_serve == [0] and not srv.is_alive() and restarted and rec[28]["frame_changed"]
                and bad_refused and held and rc_t == 0 and img.shape == (h, w, 3)
                and np.isfinite(img).all() and img.mean() > 0 and png.shape == (h, w, 3)
                and set(ln) == {"isect_brute"} and ln["isect_brute"] % per_round == 0):
            raise AssertionError(f"live view: {rec[28]}")
        phase(28, f"render --serve on {dev.type}: {s_round:.4f} s per round, {mpaths:.4f} "
                  f"Mpaths/s; edit, pause, resume, stop and tonemap worked")
    return rec


# ---- phases 29-31: several devices, several ranks, the spheres' LBVH

LAYERS = ("composite", "albedo", "normal", "weights")
# pixels where phase 29 splits a launch over 800x600: neither a multiple of
# 32 (the medium branch's pixels per warp) nor of 640 (the small branch's
# block)
SPLIT_PIX = 123_457
# a sphere leaf read: four 20-byte slots (ops/bvh.py: build_sphere_tables)
SPH_LEAF_BYTES = 80


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _films_equal(a: dict, b: dict) -> bool:
    return all(np.array_equal(a[k], b[k]) for k in LAYERS)


def sharded(dev, smi: str, reset_counts, read_counts) -> dict:
    """Phase 29 on `dev`: `render_sharded` on the mesh of every visible card
    and on four entries of `dev`, split path-kernel launches, the scan path
    and the train step on the (2, 2) mesh; returns the phase's record."""
    from optix_renderer_tpu_torch.ops.cuda import pathk
    from optix_renderer_tpu_torch.parallel.shard import (
        make_mesh,
        render_sharded,
        sharded_train_step,
        train_step,
    )
    from optix_renderer_tpu_torch.render.mega_render import GROUP
    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.scene.presets import make_cornell_box, make_tessellated_cornell

    meshes = {"all_cards": make_mesh(), "cuda0_x4": make_mesh(devices=[dev] * 4)}
    for name, mesh in meshes.items():
        print(f"  mesh {name}: {mesh.shape}, entries {[str(d) for d in mesh.flat]}")
    rec = {"meshes": {k: list(m.shape) for k, m in meshes.items()}, "kernel_path": {}}
    box, cfg_box, _ = make_cornell_box(800, 600, 16, "path_mis", device=dev)
    cfg_box = dataclasses.replace(cfg_box, max_depth=16, rfilter="gaussian")
    m_scene, cfg_m, _ = make_tessellated_cornell(800, 600, 16, "path_mis", nu=40, nv=51,
                                                 device=dev)
    cfg_m = dataclasses.replace(cfg_m, max_depth=16, rfilter="gaussian")
    # the kernel path: the film of render_sharded equals render()'s bit for
    # bit, with one launch per mesh entry and group of samples
    for cell, scene, cfg in (("cornell", box, cfg_box), ("config_m", m_scene, cfg_m)):
        ref = render(scene, cfg, device=dev)
        for name, mesh in meshes.items():
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.time()
            out = render_sharded(scene, cfg, mesh)
            dt = time.time() - t0
            n = read_counts()
            want = mesh.size * -(-cfg.sample_count // GROUP)
            err = max(float(np.abs(out[k] - ref[k]).max()) for k in LAYERS)
            rec["kernel_path"][f"{cell}_{name}"] = {"launches": n["pathk"], "expected": want,
                                                   "s": dt, "max_abs_err": err}
            print(f"  render_sharded {cell} on {name}: {dt:.4f} s, {n['pathk']} path-kernel "
                  f"launches ({want} expected), film equal to render(): {_films_equal(out, ref)}",
                  flush=True)
            if not (_films_equal(out, ref) and n["pathk"] == want
                    and sum(v for k, v in n.items() if k != "pathk") == 0):
                raise AssertionError(f"render_sharded {cell} on {name}: launches {n}, film max "
                                     f"|diff| {err}")
    # pathk_trace over two ranges against one launch, both branches
    rec["split_launch"] = {}
    for branch, scene, cfg in (("small", box, cfg_box), ("medium", m_scene, cfg_m)):
        tables, meta = pathk.build_pathk_tables(scene, cfg, dev)
        n_pix = cfg.width * cfg.height
        whole = pathk.pathk_trace(tables, meta, cfg, n_pix=n_pix, spp0=0, n_spp=16)
        parts = [pathk.pathk_trace(tables, meta, cfg, n_pix=n, spp0=0, n_spp=16, pix0=p0)
                 for p0, n in ((0, SPLIT_PIX), (SPLIT_PIX, n_pix - SPLIT_PIX))]
        joined = torch.cat(parts, dim=1)
        torch.cuda.synchronize()
        equal = torch.equal(joined, whole)
        rec["split_launch"][branch] = {"equal": equal, "launch": pathk.last_launch()}
        print(f"  pathk_trace {branch} branch, pixels [0, {SPLIT_PIX}) + [{SPLIT_PIX}, {n_pix}) "
              f"against one launch: rows equal {equal}", flush=True)
        if not equal:
            raise AssertionError(f"{branch} branch: split rows differ on "
                                 f"{int((joined != whole).any(0).sum())} pixels")
    # the scan path: config B on the (2, 2) mesh of dev
    mesh4 = meshes["cuda0_x4"]
    cfg_b = dataclasses.replace(cfg_box, rfilter="mitchell", sample_count=2)
    ref = render(box, cfg_b, device=dev)
    reset_counts()
    t0 = time.time()
    out = render_sharded(box, cfg_b, mesh4)
    dt = time.time() - t0
    n = read_counts()
    # 2 calls per bounce (closest hit, NEE shadow ray) for each of the 4
    # entries' one 240,000-lane chunk, in 1 round of 2 samples
    want = 2 * cfg_b.max_depth * mesh4.size
    err = float(np.abs(out["composite"] - ref["composite"]).max())
    rec["scan_path"] = {"launches": n["isect_brute"], "expected": want, "s": dt,
                        "max_abs_err": err, "spp_done": out["spp_done"]}
    print(f"  render_sharded config B 2 spp on cuda0_x4: {dt:.4f} s, isect_brute {n['isect_brute']}"
          f" ({want} expected), composite max |diff| against render() {err:.3e}", flush=True)
    if not (err <= 2e-4 and n["isect_brute"] == want and n["pathk"] == 0
            and out["spp_done"] == 2):
        raise AssertionError(f"render_sharded config B: {rec['scan_path']}, launches {n}")
    # the train step on the (2, 2) mesh against train_step on both samples of
    # every pixel in one film
    cfg_t = dataclasses.replace(cfg_box, sample_count=1)
    target = render(box, cfg_t, sample_count=1, device=dev)["composite"]
    target = torch.from_numpy(target * 0.8)
    ids = torch.arange(cfg_t.width * cfg_t.height)

    def one_device():
        return train_step(box, cfg_t, target, torch.cat([ids, ids]),
                          torch.cat([torch.full_like(ids, 3), torch.full_like(ids, 4)]),
                          device=dev)

    def on_mesh():
        return sharded_train_step(box, cfg_t, mesh4, target, ids, 3)

    # timed in turns, one device, mesh, one device, mesh: a step's first call
    # in a process also pays for the allocator's growth (to ~42 GB)
    secs = {"one_device_s": [], "sharded_s": []}
    for key, fn in (("one_device_s", one_device), ("sharded_s", on_mesh)) * 2:
        torch.cuda.synchronize()
        t0 = time.time()
        loss, grads = fn()
        grads = {k: v.cpu() for k, v in grads.items()}
        secs[key].append(time.time() - t0)
        if key == "sharded_s":
            loss_s, g_s = loss, grads
        else:
            loss_1, g_1 = loss, grads
        del grads
    loss_rel = abs(float(loss_s) - float(loss_1)) / abs(float(loss_1))
    g_err = {k: float((g_s[k] - g_1[k]).abs().max() / g_1[k].norm().clamp(min=1e-30))
             for k in g_1}
    rec["train_step"] = {"loss_sharded": float(loss_s), "loss_one": float(loss_1),
                         "loss_rel_err": loss_rel, "grad_err_of_norm": g_err, **secs}
    print(f"  sharded_train_step on cuda0_x4 against train_step (both samples of 480,000 "
          f"pixels): {json.dumps(rec['train_step'])}", flush=True)
    if not (loss_rel <= 1e-5 and all(e <= 1e-4 for e in g_err.values())):
        raise AssertionError(f"sharded_train_step: {rec['train_step']}")
    del g_s, g_1
    # where the sharded step's time goes: one traced step of each, with the
    # device events' count, the device's busy time and idle share, and the
    # copies (all four entries are one card, so the films' .to(first) copy
    # nothing)
    sums = ("Memcpy", "DtoD", "Memset")
    traces = {"one_device": device_trace(one_device, sums),
              "sharded": device_trace(on_mesh, sums)}
    rec["train_step"]["trace"] = traces
    for name, tr in traces.items():
        print(f"  traced {name} step: {json.dumps(tr)}", flush=True)
    torch.cuda.empty_cache()
    # Mpaths/s of the 512-spp bench config: render_sharded on every card
    # against render()
    cfg_512 = dataclasses.replace(cfg_box, sample_count=512)
    rates = {}
    for name, fn in (("render", lambda: render(box, cfg_512, device=dev)),
                     ("render_sharded_all_cards",
                      lambda: render_sharded(box, cfg_512, meshes["all_cards"]))):
        fn()
        torch.cuda.synchronize()
        t0 = time.time()
        fn()
        rates[name] = 800 * 600 * 512 / (time.time() - t0) / 1e6
    rec["mpaths_512"] = rates
    print(f"  512 spp 800x600 Cornell on {smi}: {json.dumps(rates)} Mpaths/s", flush=True)
    phase(29, f"sharded: kernel-path films bit-equal to render() with {mesh4.size} launches per "
              f"group on four entries, split launches equal in both branches, config B within "
              f"{err:.1e}, the train step within {max(g_err.values()):.1e} of its norm")
    return rec


def multihost(dev, smi: str) -> dict:
    """Phase 30: two mh_worker ranks on gloo sharing `dev`, against one
    process; then `cli scaling` on the card."""
    from optix_renderer_tpu_torch.parallel.shard import train_step
    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.scene.presets import make_cornell_box

    rec = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mh_") as tmp:
        out = Path(tmp) / "mh.npz"
        port = _free_port()
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "optix_renderer_tpu_torch.parallel.mh_worker",
             "--coordinator", f"localhost:{port}", "--num-processes", "2", "--process-id",
             str(i), "--local-devices", "2", "--device", dev.type, "--backend", "gloo",
             "--out", str(out)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for i in range(2)]
        logs = []
        for p in procs:
            try:
                logs.append(p.communicate(timeout=300)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs.append(p.communicate()[0])
        for i, p in enumerate(procs):
            print("\n".join(f"  [rank {i}] {ln}" for ln in logs[i].splitlines()
                            if "socket" not in ln))
            if p.returncode != 0:
                raise AssertionError(f"mh_worker {i} exited {p.returncode}")
        rec["workers_s"] = time.time() - t0
        z = dict(np.load(out))
        scaling = subprocess.run(
            [sys.executable, "-m", "optix_renderer_tpu_torch", "scaling", "--device", dev.type,
             "-o", str(Path(tmp) / "scaling.json")], cwd=ROOT, check=True, timeout=600,
            capture_output=True, text=True).stdout
    scene, cfg, _ = make_cornell_box(width=16, height=12, spp=4, integrator="path_mis",
                                     device=dev)
    cfg = dataclasses.replace(cfg, max_depth=3)
    ref = render(scene, cfg, sample_count=4, device=dev, mega=False)
    # render_sharded's kernel path over the two ranks' pixel ranges: the
    # ranges are disjoint, so the film equals one process's bit for bit
    ref_k = render(scene, cfg, sample_count=4, device=dev)
    kernel_equal = all(np.array_equal(z[f"kernel_{k}"], ref_k[k]) for k in LAYERS)
    loss, grads = train_step(scene, cfg, torch.zeros((12, 16, 3)), torch.arange(16 * 12), 0,
                             device=dev)
    film_err = float(np.abs(z["composite"] - ref["composite"]).max())
    loss_err = abs(float(z["loss"]) - float(loss))
    # each gradient's max |diff| over its norm, as phase 29 holds them
    g_norm = {k: float(g.norm()) for k, g in grads.items()}
    g_err = {k: float(np.abs(z[f"grad_{k}"] - g.cpu().numpy()).max()) / max(g_norm[k], 1e-30)
             for k, g in grads.items()}
    rec.update(film_max_abs_err=film_err, kernel_film_equal=kernel_equal, loss_abs_err=loss_err,
               grad_err_of_norm=g_err, grad_norm=g_norm, n_devices=int(z["n_devices"]),
               n_processes=int(z["n_processes"]))
    print(f"  two gloo ranks x 2 entries of {dev}, 16x12 depth 3 4 spp, against one process: "
          f"{json.dumps(rec)}", flush=True)
    if not (film_err <= 1e-5 and kernel_equal and loss_err <= 1e-4
            and all(e <= 1e-4 for e in g_err.values()) and g_norm["em_radiance"] > 0
            and bool(z["grad_finite"]) and rec["n_processes"] == 2):
        raise AssertionError(f"two ranks against one process: {rec}")
    res = json.loads(scaling[scaling.index("{"):])
    rec["scaling"] = res
    print(f"  cli scaling --device {dev.type} on {smi}: {json.dumps(res)}")
    print(f"  scaling efficiency {res['scaling_efficiency']} with {res['n_devices']} device: 1 "
          "by construction on one card; a scaling number needs a machine with more cards")
    if not (res["n_devices"] == 1 and res["scaling_efficiency"] == 1.0
            and res["paths_per_s_1dev"] > 0):
        raise AssertionError(f"cli scaling: {res}")
    phase(30, f"two ranks on one card match one process (scan film {film_err:.1e}, kernel film "
              f"equal, grads {max(g_err.values()):.1e} of their norms); cli scaling ran")
    return rec


def spheres(dev, smi: str, reset_counts, read_counts) -> dict:
    """Phase 31: `isect_spheres` against its plain version on a 10,000-sphere
    soup, its times beside its bound, and an 80-sphere scene through
    render(); returns the phase's record."""
    from optix_renderer_tpu_torch.ops import bvh
    from optix_renderer_tpu_torch.ops.cuda import _build, isect
    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.scene.build import load_scene
    from optix_renderer_tpu_torch.scene.presets import sphere_cornell_xml
    from optix_renderer_tpu_torch.tools.time_isect import (
        MAIN_RAYS,
        device_ms,
        profiled_ms,
        ptxas_report,
        sphere_soup,
    )

    rng = np.random.default_rng(31)
    tree, cam, shadow = sphere_soup(isect, dev, rng)
    print(f"  soup: 10,000 spheres, {tree.pairs.shape[0]} pair rows, {tree.leaf.shape[0]} leaves, "
          f"{tree.depth} levels; {MAIN_RAYS} camera and shadow rays")
    rec = {"rays": MAIN_RAYS}
    sets = (("closest_camera", cam, False), ("any_shadow", shadow, True))
    for name, rays, any_hit in sets:
        got = isect.isect_spheres(tree, *rays, any_hit=any_hit, with_visits=True)
        ref, plain_ms = timed(lambda: bvh.traverse_spheres_ref(tree.packed, tree.leaf, *rays,
                                                               any_hit=any_hit))
        err = (gate_any if any_hit else gate_closest)(f"isect_spheres {name}", got[:2], ref)
        if not any_hit:
            same = got[0] == ref[0]
            if not torch.equal(got[1][same], ref[1][same]):
                raise AssertionError("isect_spheres: t differs where the ids agree")
        vis = got[2].double()
        rows, leaves = float(vis[0].sum()), float(vis[1].sum())
        ops = rows * OPS_PAIR + leaves * bvh.LEAF_SIZE * OPS_SPHERE + MAIN_RAYS * OPS_RAY
        nbytes = MAIN_RAYS * (32 + 8) + (tree.pairs.numel() + tree.leaf.numel()) * 4
        bnd = bound(ops, nbytes)
        # the row's time: CUDA events behind a spin (median of 7); beside it
        # the profiler's time of the kernel alone, None where its trace holds
        # no device event of the kernel (a whole run of this script on an
        # H100 showed none here, after phase 30)
        alone = profiled_ms(lambda: isect.isect_spheres(tree, *rays, any_hit=any_hit), 7,
                            "SphLeaf") or None
        spin = float(np.median(device_ms(
            lambda: isect.isect_spheres(tree, *rays, any_hit=any_hit), 7)))
        rec[name] = {"max_abs_err": err, "ms": spin, "ms_alone_profiler": alone,
                     "plain_ms": plain_ms, "bound": bnd, "rows_per_ray": rows / MAIN_RAYS,
                     "leaves_per_ray": leaves / MAIN_RAYS, "launch": isect.last_launch()}
        print(f"  isect_spheres {name}: {spin:.4f} ms behind a spin, alone (torch.profiler) "
              f"{'no device events' if alone is None else f'{alone:.4f} ms'}, "
              f"plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms "
              f"({bnd[1]}; {rows / MAIN_RAYS:.2f} pair rows and {leaves / MAIN_RAYS:.2f} leaves "
              f"per ray) on {smi}", flush=True)
    rec["ptxas"] = {k: v for k, v in ptxas_report(_build.last_build.get("ptxas", "")).items()
                    if re.search(r"isect10bvh_kernel", k)}
    print(f"  ptxas, bvh_kernel<ANY, LEAF>: {rec['ptxas']}")
    # an 80-sphere scene through render(): the scan path, isect_spheres
    # closest and any once per bounce
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sph_") as tmp:
        scene, cfg, _ = load_scene(sphere_cornell_xml(tmp, 800, 600, 4, "path_mis"), dev)
        small, cfg_small, _ = load_scene(sphere_cornell_xml(tmp, 64, 48, 4, "path_mis"), dev)
    cfg = dataclasses.replace(cfg, max_depth=8)
    render(scene, cfg, sample_count=1, device=dev)  # warm-up
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    out = render(scene, cfg, device=dev)
    dt = time.time() - t0
    n = read_counts()
    want = cfg.max_depth * cfg.sample_count
    rec["render"] = {"launches": n, "s": dt, "mpaths_s": 800 * 600 * 4 / dt / 1e6,
                     "mean": float(out["composite"].mean())}
    print(f"  80 spheres 800x600 path_mis depth 8, 4 spp: {dt:.4f} s, "
          f"{rec['render']['mpaths_s']:.4f} Mpaths/s on {smi}; launches {n}", flush=True)
    if not (n["isect_spheres_closest"] == want and n["isect_spheres_any"] == want
            and n["isect_brute"] == 2 * want and n["pathk"] == 0
            and np.isfinite(out["composite"]).all() and out["composite"].mean() > 0):
        raise AssertionError(f"80-sphere render: launches {n}, expected {want} per walk")
    cfg_small = dataclasses.replace(cfg_small, max_depth=8)
    a = render(small, cfg_small, device=dev)["composite"]
    b = render(small, cfg_small, device="cpu")["composite"]
    rel = np.abs(a - b) / (np.abs(b) + 1e-3)
    st = {"median_rel_err": float(np.median(rel)), "mean_cuda": float(a.mean()),
          "mean_cpu": float(b.mean())}
    rec["card_vs_cpu_64x48"] = st
    print(f"  80 spheres 64x48, cuda against cpu: {json.dumps(st)}")
    if not (st["median_rel_err"] < 1e-3
            and abs(st["mean_cuda"] - st["mean_cpu"]) <= 0.1 * abs(st["mean_cpu"])):
        raise AssertionError(f"80 spheres: the card's film differs from the CPU's: {st}")
    phase(31, f"isect_spheres agrees with its plain version at {MAIN_RAYS} rays; the 80-sphere "
              f"scene launched it {want} + {want} times")
    return rec


# ---- phase 32: wavefront path regeneration (render/wavefront.py)


def _counted_wavefront(scene, cfg, spp: int, dev) -> tuple:
    """`render_wavefront` at its defaults (2^19 lanes, a host read every 8
    iterations) with `wavefront_iter` wrapped, the module function, to
    record per iteration the live lanes before the refill, the work counter
    before and after and the live lanes after, as device tensors read once
    at the end. Returns (the film, the iterations' record)."""
    from optix_renderer_tpu_torch.render import wavefront as wf

    rows = []
    orig = wf.wavefront_iter

    def counted(acc, state, *a, **k):
        before = torch.stack([state.path.active.sum(), state.next_work])
        state, n_active = orig(acc, state, *a, **k)
        rows.append(torch.cat([before, torch.stack([state.next_work, n_active])]))
        return state, n_active

    wf.wavefront_iter = counted
    try:
        out = wf.render_wavefront(scene, cfg, sample_count=spp, device=dev)
    finally:
        wf.wavefront_iter = orig
    r = torch.stack(rows).cpu().numpy().astype(np.int64)
    total = cfg.width * cfg.height * spp
    lanes = min(1 << 19, total)
    # lanes live in each iteration's bounce: those carried over and those
    # the refill spawned
    live = r[:, 0] + np.minimum(r[:, 2], total) - np.minimum(r[:, 1], total)
    iters = len(r)
    idle = int((live == 0).sum())
    if idle and not np.all(live[iters - idle:] == 0):
        raise AssertionError(f"iterations with no live lane before the end: {live.tolist()}")
    rec = {"iterations": iters, "lanes": lanes, "work_items": total,
           "iterations_per_sample": iters / spp,
           "segments_per_path": float(live.sum()) / total,
           "path_length_from_iterations": iters * lanes / total,
           "idle_iterations": idle, "spp_done": out["spp_done"]}
    return out, rec


def _splatted(fn) -> tuple:
    """(fn(), (pos [M,2], layers [3,M,3])): every lane that `film.splat_`
    adds into a film during fn(), its mask applied, on the device."""
    from optix_renderer_tpu_torch.render import film as film_ops

    kept = []
    orig = film_ops.splat_

    def keep(img, rfilter, pos, layers, mask=None):
        kept.append((pos, layers) if mask is None else (pos[mask], layers[:, mask]))
        return orig(img, rfilter, pos, layers, mask=mask)

    film_ops.splat_ = keep
    try:
        out = fn()
    finally:
        film_ops.splat_ = orig
    return out, (torch.cat([p for p, _ in kept]), torch.cat([v for _, v in kept], dim=1))


@contextlib.contextmanager
def _eager_scan():
    """Within it, `render.scan_step` runs every round eagerly (no graph)
    through the torch chain (the rule answers None: no shading kernel): the
    wavefront's bounce is that chain's (`integrators/path.py:
    path_bounce`)."""
    from optix_renderer_tpu_torch.render import scan_graph

    saved = scan_graph.graph_step, scan_graph.shade_scene
    scan_graph.graph_step = scan_graph.eager_step
    scan_graph.shade_scene = lambda scene, config, device: None
    try:
        yield
    finally:
        scan_graph.graph_step, scan_graph.shade_scene = saved


def _same_paths(a: tuple, b: tuple) -> bool:
    """Whether two `_splatted` records hold the same samples: positions and
    layers bit for bit, each set sorted by its position's bits (every
    position distinct, so the order is the same)."""
    def in_order(rec):
        pos, vals = rec
        bits = pos.contiguous().view(torch.int32).to(torch.int64)
        key = (bits[:, 0] << 32) | (bits[:, 1] & 0xFFFFFFFF)
        order = torch.argsort(key)
        return key[order], vals[:, order]

    (ka, va), (kb, vb) = in_order(a), in_order(b)
    if ka.shape != kb.shape or torch.unique(ka).numel() != ka.numel():
        return False
    return torch.equal(ka, kb) and torch.equal(va, vb)


def wavefront(dev, smi: str, reset_counts, read_counts) -> dict:
    """Phase 32: `render_wavefront` bit for bit against the scan path on the
    card with its launches exact per iteration, then timed against the scan
    path (config B) and the path kernel (gaussian Cornell, 16 spp);
    returns the phase's record."""
    from optix_renderer_tpu_torch.render import film as film_ops
    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.scene.presets import make_cornell_box, make_tessellated_cornell

    layers = ("composite", "albedo", "normal", "weights")
    rec = {"bit_equal": {}}
    # (i, ii) each path bit for bit and the films, box filter, with the
    # launches per iteration. A sample lands in one pixel with weight 1,
    # but where its jitter lies within an ulp of 1, pixel + jitter rounds to
    # the next pixel's edge and the sample lands there: that pixel then adds
    # three samples, in the order their paths end, which the scan does not
    # share. So the paths are held as a set (every splatted position and
    # its layers equal), and the films bit for bit on every pixel of at
    # most two samples (two additions commute).
    cases = (("cornell_path_mis_2spp", "path_mis", 16, 2, {"isect_brute": 2}),
             ("cornell_path_mats_2spp", "path_mats", 16, 2, {"isect_brute": 1}),
             ("config_a_path_mis_1spp", "path_mis", 8, 1,
              {"isect_bvh_closest": 1, "isect_bvh_any": 1}))
    for name, integ, depth, spp, per_iter in cases:
        if name.startswith("config_a"):
            scene, cfg, _ = make_tessellated_cornell(800, 600, spp, integ, device=dev)
        else:
            scene, cfg, _ = make_cornell_box(800, 600, spp, integ, device=dev)
        cfg = dataclasses.replace(cfg, max_depth=depth, rfilter="box")
        with _eager_scan():  # a replayed round calls no `film.splat_`
            scan, scan_paths = _splatted(
                lambda: render(scene, cfg, sample_count=spp, device=dev, mega=False))
        reset_counts()
        (wave, it), wave_paths = _splatted(lambda: _counted_wavefront(scene, cfg, spp, dev))
        n = read_counts()
        same_paths = _same_paths(scan_paths, wave_paths)
        three = scan["weights"] > 2  # box filter: the weight counts the samples
        differ = {k: int((wave[k] != scan[k]).reshape(*three.shape, -1).any(-1).sum())
                  for k in layers}
        differ_two = {k: int(((wave[k] != scan[k]).reshape(*three.shape, -1).any(-1)
                              & ~three).sum()) for k in layers}
        want = {k: v * it["iterations"] for k, v in per_iter.items()}
        it.update(launches=n, paths=int(scan_paths[0].shape[0]), paths_equal=same_paths,
                  pixels_over_two_samples=int(three.sum()), pixels_differ=differ,
                  max_abs_err=max(float(np.abs(wave[k] - scan[k]).max()) for k in layers))
        rec["bit_equal"][name] = it
        print(f"  {name} ({cfg.n_tris} triangles, depth {depth}, box): {json.dumps(it)}",
              flush=True)
        if not same_paths:
            raise AssertionError(f"{name}: the wavefront's paths differ from the scan path's")
        if any(differ_two.values()) or not np.array_equal(wave["weights"], scan["weights"]):
            raise AssertionError(f"{name}: the wavefront film differs from the scan path's on "
                                 f"{differ_two} pixels of at most two samples")
        others = {k: v for k, v in n.items() if k not in want}
        if any(n[k] != v for k, v in want.items()) or any(others.values()):
            raise AssertionError(f"{name}: launches {n}, expected {want} for "
                                 f"{it['iterations']} iterations")
        if wave["spp_done"] != spp or scan["weights"].sum() != cfg.width * cfg.height * spp:
            raise AssertionError(f"{name}: spp_done {wave['spp_done']}, samples "
                                 f"{scan['weights'].sum()}")
    del scene, scan, wave

    # (iii) wall clock to the film on the host, in turns
    def timed_runs(scene, cfg, spp, kinds):
        render(scene, cfg, sample_count=1, device=dev)  # warm-up of both
        render(scene, cfg, sample_count=1, device=dev, wavefront=True)
        secs = {k: [] for k in kinds}
        peak = dict.fromkeys(kinds, 0)
        for k in (kinds[0], kinds[1], kinds[1], kinds[0]):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()  # the render's own peak is above it
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            out = render(scene, cfg, sample_count=spp, device=dev, wavefront=k == "wavefront")
            secs[k].append(time.time() - t0)
            peak[k] = max(peak[k], torch.cuda.max_memory_allocated() - base)
            if not (np.isfinite(out["composite"]).all() and out["composite"].mean() > 0
                    and out["spp_done"] == spp):
                raise AssertionError(f"{k}: the film is not finite / positive")
        n_paths = cfg.width * cfg.height * spp
        return {k: {"s": v, "mpaths_s": [n_paths / s / 1e6 for s in v], "peak_gb": peak[k] / 1e9}
                for k, v in secs.items()}

    scene_b, cfg_b, _ = make_cornell_box(800, 600, 4, "path_mis", device=dev)
    cfg_b = dataclasses.replace(cfg_b, max_depth=16, rfilter="mitchell")
    def counted_launches(scene, cfg, spp):
        """The counted run's record with its launches, `isect_brute` exactly
        2 per iteration (path_mis, 12 triangles) and nothing else."""
        reset_counts()
        _, it = _counted_wavefront(scene, cfg, spp, dev)
        it["launches"] = n = read_counts()
        if n["isect_brute"] != 2 * it["iterations"] or sum(n.values()) != n["isect_brute"]:
            raise AssertionError(f"launches {n} for {it['iterations']} iterations")
        return it

    rec["config_b"] = timed_runs(scene_b, cfg_b, 4, ("scan", "wavefront"))
    rec["config_b"]["wavefront_iterations"] = counted_launches(scene_b, cfg_b, 4)
    rec["config_b"]["trace"] = {
        k: device_trace(lambda: render(scene_b, cfg_b, sample_count=4, device=dev,
                                       wavefront=k == "wavefront"),
                        sums=("brute_kernel", "index"))
        for k in ("scan", "wavefront")}
    print(f"  config B (mitchell, path_mis, depth 16, 800x600, 4 spp) on {smi}: "
          f"{json.dumps(rec['config_b'])}", flush=True)

    scene_g, cfg_g, _ = make_cornell_box(800, 600, 16, "path_mis", device=dev)
    cfg_g = dataclasses.replace(cfg_g, max_depth=16, rfilter="gaussian")
    rec["cornell_gaussian_16spp"] = timed_runs(scene_g, cfg_g, 16, ("kernel", "wavefront"))
    rec["cornell_gaussian_16spp"]["wavefront_iterations"] = counted_launches(scene_g, cfg_g, 16)
    print(f"  gaussian Cornell (path_mis, depth 16, 800x600, 16 spp) on {smi}: "
          f"{json.dumps(rec['cornell_gaussian_16spp'])}", flush=True)

    # one masked splat over the pool, the mitchell filter, a fifth of the
    # lanes ending (CUDA events, after a warm-up)
    g = torch.Generator(device=dev).manual_seed(32)
    n = 1 << 19
    pos = torch.rand((n, 2), device=dev, generator=g) * torch.tensor([800.0, 600.0], device=dev)
    vals = torch.rand((3, n, 3), device=dev, generator=g)
    mask = torch.rand(n, device=dev, generator=g) < 0.2
    acc = torch.zeros((3, 600, 800, 4), device=dev)
    rec["splat_ms"] = {
        "masked": event_ms(lambda: film_ops.splat_(acc, "mitchell", pos, vals, mask=mask), 5),
        "unmasked_480000": event_ms(
            lambda: film_ops.splat_(acc, "mitchell", pos[:480000], vals[:, :480000]), 5)}
    print(f"  splat, mitchell, 2^19 lanes masked (a fifth live) against 480,000 unmasked: "
          f"{json.dumps(rec['splat_ms'])} ms on {smi}", flush=True)
    b, gs = rec["config_b"], rec["cornell_gaussian_16spp"]
    phase(32, f"wavefront paths bit-equal to the scan path's (Cornell via isect_brute, config "
              f"A via isect_bvh); config B {np.median(b['scan']['mpaths_s']):.4f} Mpaths/s scan "
              f"against {np.median(b['wavefront']['mpaths_s']):.4f} wavefront; gaussian 16 spp "
              f"{np.median(gs['kernel']['mpaths_s']):.4f} kernel against "
              f"{np.median(gs['wavefront']['mpaths_s']):.4f} wavefront")
    return rec


# ---- phase 33: the LBVH build on the card (csrc/lbvh.cu)

LBVH_SOURCE = "optix_renderer_tpu_torch/csrc/lbvh.cu"
LBVH_REPLACES = "optix_renderer_tpu/native/lbvh.cpp:60"
# FP32 operations per primitive counted from csrc/lbvh.cu: its box twice
# (bounds_kernel and leaf_kernel, 12 compare-selects each), the centroid 6,
# the Morton quotient 18 (3 subtractions, 3 extents, 3 divisions, 3
# multiplies, 6 clamps), the leaf fold 6, the leaf slot's two edges 6; and
# per interior node its box, 6 compare-selects
OPS_LBVH_PRIM = 60
OPS_LBVH_NODE = 6


def lbvh_soup(n: int, kind: str, seed: int = 0) -> tuple:
    """n triangles as tests/test_torch_lbvh.py draws them: "plain", "zeros"
    (30 % of the coordinates +0 and 30 % -0, the first tenth of the
    triangles repeated at the end) or "same" (every centroid (1, 2, 3))."""
    rng = np.random.default_rng(seed + n)
    v0 = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    v1 = (v0 + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    v2 = (v0 + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    if kind == "zeros":
        for v in (v0, v1, v2):
            v[rng.random((n, 3)) < 0.3] = 0.0
            v[rng.random((n, 3)) < 0.3] = -0.0
        k = max(n // 10, 1)
        for v in (v0, v1, v2):
            v[-k:] = v[:k]
    elif kind == "same":
        for v in (v0, v1, v2):
            v[:] = (1.0, 2.0, 3.0)
        v0[::2, 0], v1[::2, 0], v2[::2, 0] = 0.0, 2.0, 2.0
    return v0, v1, v2


def lbvh_bound(n: int, sphere: bool) -> tuple:
    """(bound ms, what bounds it, bytes) of one build over n primitives: each
    input read once (the corners, 36 B per triangle; a sphere's centre and
    radius, 16 B), each output written once (packed 32 B per node, the leaf
    table 160 or 80 B per leaf, pairs 64 B per row), against the operations
    of `OPS_LBVH_PRIM` / `OPS_LBVH_NODE`. The sorts' passes over the 8-byte
    keys are inside the function and not counted."""
    n_leaves = -(-n // 4)
    nbytes = (n * (16 if sphere else 36) + (2 * n_leaves - 1) * 32
              + n_leaves * (80 if sphere else 160) + max(n_leaves - 1, 1) * 64)
    return (*bound(n * OPS_LBVH_PRIM + n_leaves * OPS_LBVH_NODE, nbytes), nbytes)


def kernel_events(fn, reps: int = 3) -> dict:
    """{kernel name: [device ms, count]} per call of `fn()`, over `reps`
    calls, from the profiler's raw CUDA events (as `device_trace`); empty
    where the profiler records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            name = e.name()
            m = re.search(r"lbvh::(\w+)", name)
            key = m.group(1) if m else name[:60]
            out.setdefault(key, [0.0, 0])
            out[key][0] += e.duration_ns() / 1e6 / reps
            out[key][1] += 1 / reps
    return out


def scene_tensors(x, path: str = "") -> dict:
    """{path: tensor} of every tensor of a scene."""
    from optix_renderer_tpu_torch.scene.data import PhotonMap, _Tables

    if isinstance(x, torch.Tensor):
        return {path: x}
    out = {}
    if isinstance(x, _Tables):
        for f in dataclasses.fields(x):
            out.update(scene_tensors(getattr(x, f.name), f"{path}.{f.name}"))
    elif isinstance(x, PhotonMap):
        for k in x._fields:
            out.update(scene_tensors(getattr(x, k), f"{path}.{k}"))
    return out


def tables_equal(what: str, tree, ref) -> float:
    """The card's LBVH `tree` against the numpy twin's `ref`: packed, leaf and
    pairs bit for bit, and the depth. Returns max |a - b| over the tables."""
    bad, err = {}, 0.0
    for name in ("packed", "leaf", "pairs"):
        a, b = getattr(tree, name).cpu(), getattr(ref, name).cpu()
        if a.shape != b.shape:
            raise AssertionError(f"{what}: {name} is {tuple(a.shape)}, the twin's "
                                 f"{tuple(b.shape)}")
        bad[name] = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        err = max(err, float((a - b).abs().nan_to_num(0.0).max()))
    if any(bad.values()) or tree.depth != ref.depth:
        raise AssertionError(f"{what}: words that differ from the numpy twin {bad}, depth "
                             f"{tree.depth} against {ref.depth}")
    return err


def lbvh(dev, smi: str, reset_counts, read_counts, launches_a: dict) -> dict:
    """Phase 33: the LBVH build on the card (`ops/bvh.py: build_bvh` /
    `build_sphere_bvh` on CUDA, the chain of csrc/lbvh.cu) bit for bit
    against its numpy twin, timed beside the twin's host build and upload;
    config A loaded on the card and on the host (every tensor equal) and
    rendered from each; returns the phase's record."""
    from optix_renderer_tpu_torch.ops import bvh
    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.scene.build import load_scene
    from optix_renderer_tpu_torch.scene.presets import (
        medium_cornell_xml,
        sphere_cornell_xml,
        tessellated_cornell_xml,
    )

    rec = {"sizes": {}}
    tmp_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_lbvh_")
    tmp = Path(tmp_dir.name)
    xml_a = tessellated_cornell_xml(tmp, 800, 600, 4, "path_mis")
    host_a, _, _ = load_scene(xml_a, "cpu")
    host_s, _, _ = load_scene(sphere_cornell_xml(tmp, 800, 600, 4, "path_mis"), "cpu")
    g = host_a.geometry
    rng = np.random.default_rng(33)
    spheres = {n: (rng.uniform(-3, 3, (n, 3)).astype(np.float32),
                   rng.uniform(0.01, 0.2, n).astype(np.float32)) for n in (65, 10_000)}
    for c, _ in spheres.values():
        c[rng.random(c.shape) < 0.2] = -0.0
        c[rng.random(c.shape) < 0.2] = 0.0
    spheres[80] = (host_s.geometry.sph_center.numpy(), host_s.geometry.sph_radius.numpy())
    cases = {f"tri_{n}": lbvh_soup(n, "plain") for n in (1, 3, 4, 257, 1000, 4097)}
    cases["config_a_100012"] = tuple(x.numpy() for x in (g.tri_v0, g.tri_v0 + g.tri_e1,
                                                          g.tri_v0 + g.tri_e2))
    cases["same_centroid_1000"] = lbvh_soup(1000, "same")
    cases["zeros_1000000"] = lbvh_soup(1_000_000, "zeros")
    cases["zeros_4000000"] = lbvh_soup(4_000_000, "zeros")
    cases.update({f"spheres_{n}": v for n, v in spheres.items()})
    timed_cases = ("config_a_100012", "zeros_1000000", "zeros_4000000", "spheres_10000")
    err = 0.0
    for name, arrays in cases.items():
        sphere = name.startswith("spheres")
        build = bvh.build_sphere_bvh if sphere else bvh.build_bvh
        on_dev = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrays]
        _sync(dev)
        tree = build(*on_dev, dev)
        # the twin: the numpy build on the host, then its tables uploaded
        t0 = time.time()
        ref = build(*arrays, "cpu")
        host_s_ = time.time() - t0
        up = ref.to(dev)
        _sync(dev)
        plain_s = time.time() - t0
        err = max(err, tables_equal(name, tree, ref))
        n = arrays[0].shape[0]
        b_ms, b_by, nbytes = lbvh_bound(n, sphere)
        row_ = {"n": n, "nodes": int(tree.packed.shape[0]), "pair_rows": int(tree.pairs.shape[0]),
                "depth": tree.depth, "plain_host_ms": host_s_ * 1e3, "plain_ms": plain_s * 1e3,
                "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
        if name in timed_cases:
            row_["ms_each"] = [event_ms(lambda: build(*on_dev, dev)) for _ in range(5)]
            row_["ms"] = float(np.median(row_["ms_each"]))
            # the chain's two torch.sort calls, timed apart on as many
            # unique int64 keys (n, then one per node), and each kernel by
            # torch.profiler (which, late in a whole run, drops some of this
            # phase's kernel events, so the sorts' share is not read from it)
            gen = torch.Generator(device=dev).manual_seed(n)
            keys = (torch.randint(0, 2**30, (n,), device=dev, generator=gen) << 32) | \
                torch.arange(n, device=dev)
            pkeys = torch.randperm(row_["nodes"], device=dev, generator=gen)
            sort_each = [event_ms(lambda: (torch.sort(keys), torch.sort(pkeys)))
                         for _ in range(5)]
            row_["sort_ms"] = float(np.median(sort_each))
            row_["sort_share"] = row_["sort_ms"] / row_["ms"]
            row_["kernels"] = kernel_events(lambda: build(*on_dev, dev)) or "not measured"
        rec["sizes"][name] = row_
        print(f"  {name}: card build bit-equal to the numpy twin; {json.dumps(row_)}",
              flush=True)
        del tree, ref, up, on_dev
    rec["max_abs_err"] = err

    # config A loaded on the card: one build chain, every tensor equal to
    # the host build's
    reset_counts()
    tracing.reset_counters("launch.lbvh_build")
    card_a, cfg_a, _ = load_scene(xml_a, dev)
    launches = tracing.counter("launch.lbvh_build")
    if launches != 1 or any(read_counts().values()):
        raise AssertionError(f"config A's load launched the build {launches} times, "
                             f"other kernels {read_counts()}")
    got, want = scene_tensors(card_a), scene_tensors(host_a)

    def bits(t):
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]) \
            if t.is_floating_point() else t

    bad = [k for k in want if got[k].device.type != dev.type or got[k].dtype != want[k].dtype
           or got[k].shape != want[k].shape or not torch.equal(bits(got[k].cpu()), bits(want[k]))]
    if got.keys() != want.keys() or bad:
        raise AssertionError(f"config A on the card differs from the host build: {bad}")
    rec.update(launches=launches, tensors_equal=len(got))

    # the copy that render() made of a host-built scene (scan_step's
    # scene.to(device)), now gone: config A and config H
    host_h, _, _ = load_scene(medium_cornell_xml(tmp, 800, 600, 1, "path_vol_mis", "H"), "cpu")
    to_ms = {}
    for name, sc in (("config_a", host_a), ("config_h", host_h)):
        ms = []
        for _ in range(3):
            _sync(dev)
            t0 = time.time()
            sc.to(dev)
            _sync(dev)
            ms.append((time.time() - t0) * 1e3)
        to_ms[name] = ms
    rec["scene_to_ms"] = to_ms
    print(f"  scene.to(cuda) of a host-built scene, ms (3 each): {json.dumps(to_ms)}", flush=True)

    # end to end: config A at phase 8's settings from the card-built scene
    # (launches equal to phase 8's) against the host-built scene (films by
    # the median statistic: the splat's order on the card is not fixed);
    # then load_scene, and load_scene + render, on each device in turns
    cfg_a = dataclasses.replace(cfg_a, max_depth=8, rfilter="gaussian")
    render(card_a, cfg_a, sample_count=1, device=dev)  # warm-up
    reset_counts()
    out_card = render(card_a, cfg_a, sample_count=4, device=dev)
    ln = read_counts()
    if ln != {**{k: 0 for k in ln}, **launches_a}:
        raise AssertionError(f"config A from the card-built scene launched {ln}, phase 8 "
                             f"{launches_a}")
    out_host = render(host_a, cfg_a, sample_count=4, device=dev)
    a, b = out_card["composite"], out_host["composite"]
    rel = np.abs(a - b) / (np.abs(b) + 1e-3)
    st = {"median_rel_err": float(np.median(rel)), "max_abs_err": float(np.abs(a - b).max()),
          "mean_card_built": float(a.mean()), "mean_host_built": float(b.mean())}
    if not (np.isfinite(a).all() and a.shape == (cfg_a.height, cfg_a.width, 3)
            and st["median_rel_err"] < 1e-3
            and abs(st["mean_card_built"] - st["mean_host_built"])
            <= 0.1 * abs(st["mean_host_built"])):
        raise AssertionError(f"config A from the card-built scene: {st}")
    load_s = {"cuda": [], "cpu": []}
    e2e = {"card_built_s": [], "host_built_s": []}
    for key, d in (("host_built_s", "cpu"), ("card_built_s", dev)) * 2:
        _sync(dev)
        t0 = time.time()
        sc, _, _ = load_scene(xml_a, d)
        _sync(dev)
        load_s[torch.device(d).type].append(time.time() - t0)
        render(sc, cfg_a, sample_count=4, device=dev)  # the film on the host
        e2e[key].append(time.time() - t0)
    rec["load_scene_s"] = load_s
    rec["config_a"] = {**st, "launches": ln, "load_and_render_s": e2e}
    print(f"  config A: load_scene on cuda and on cpu give {len(got)} tensors bit for bit; "
          f"one build chain; load_scene s {json.dumps(load_s)} on {smi}", flush=True)
    print(f"  config A 800x600 path_mis depth 8, 4 spp, card-built against host-built scene: "
          f"{json.dumps(rec['config_a'])} on {smi}", flush=True)
    tmp_dir.cleanup()
    r4 = rec["sizes"]["zeros_4000000"]
    phase(33, f"the card's LBVH build equals the numpy twin bit for bit on {len(cases)} inputs "
              f"up to 4,000,000 triangles ({r4['ms']:.3f} ms against {r4['plain_ms']:.1f} ms "
              f"on the host); config A loads on cuda as on cpu, and renders from it")
    return rec


# ---- phase 34: the scan path's shading kernel (csrc/scan.cu)

SCAN_SOURCE = "optix_renderer_tpu_torch/csrc/scan.cu"
# bytes one shade launch moves per lane under path_mis (csrc/scan.cu:
# sc::Lanes): a live lane reads and writes its state once, ~240 B (ray,
# throughput, L, MIS state, pcg32 words, shadow ray, pending term), and
# reads its winner's triangle row, 72 B; a dead lane its two flags
SHADE_LIVE_BYTES = 240 + 72
SHADE_DEAD_BYTES = 2


def scan_shading(dev, smi: str, scene_a, cfg_a, scene_b, cfg_b) -> dict:
    """Phase 34: `shade_kernel` through `li_path_fused` against the torch
    chain (`li_path_mis` / `li_path_mats`) on the 480,000 camera rays of
    configs A and B; its time per launch beside its plain version's and,
    under path_mis, its bytes bound; returns the phase's record."""
    from optix_renderer_tpu_torch.integrators import path as path_int
    from optix_renderer_tpu_torch.ops import camera as cam_ops
    from optix_renderer_tpu_torch.ops.cuda import scan as scan_shade
    from optix_renderer_tpu_torch.render import sampler as smp
    from optix_renderer_tpu_torch.render import scan_graph

    def camera_rays(scene, cfg):
        """The camera rays and samplers of `render._round_layers`, sample 3."""
        ids = torch.arange(cfg.width * cfg.height, device=dev)
        s = smp.make_sampler(ids, 3, seed=cfg.seed)
        s, jitter = smp.next_2d(s)
        s, aperture = smp.next_2d(s)
        pos = torch.stack([(ids % cfg.width).float(), (ids // cfg.width).float()], -1) + jitter
        ray, _ = cam_ops.sample_ray(scene.camera, cfg.width, cfg.height, pos, aperture)
        return ray, s

    rec = {}
    for name, scene, cfg0 in (("config_a", scene_a, cfg_a), ("config_b", scene_b, cfg_b)):
        for integ in ("path_mis", "path_mats"):
            what = f"{name} {integ}"
            cfg = dataclasses.replace(cfg0, integrator=integ, seed=2_900_000_017)
            chain = path_int.li_path_mis if integ == "path_mis" else path_int.li_path_mats
            sc = scan_graph.shade_scene(scene, cfg, dev)
            if sc is None:
                raise AssertionError(f"{what} did not take the shading kernel")
            ray, s = camera_rays(scene, cfg)
            states, live = [], []

            def recorded(sc_, lanes, bounce, hits, occ, fold_only=False):
                if not fold_only:
                    live.append(int(lanes.active.sum()))
                scan_shade.shade(sc_, lanes, bounce, hits, occ, fold_only)
                if not fold_only:
                    states.append((lanes.active.clone(), lanes.st_hi.clone(),
                                   lanes.st_lo.clone()))

            got = path_int.li_path_fused(scene, cfg, ray, s, sc, shade=recorded)
            want = chain(scene, cfg, ray, s)
            n = ray.o.shape[0]
            row = {"lanes": n, "depth": cfg.max_depth, "live_per_bounce": live}
            for layer, g, w in zip(("L", "albedo", "normal"), got[:3], want[:3]):
                if not torch.isfinite(g).all():
                    raise AssertionError(f"{what}: the kernel's {layer} is not finite")
                off = ((g - w).abs() > 1e-4 * (w.abs() + 1e-3)).any(dim=1)
                row[f"{layer}_lanes_off"] = int(off.sum())
                row[f"{layer}_max_abs_err"] = float((g - w)[~off].abs().max())
                if int(off.sum()) > n // 1000:
                    raise AssertionError(f"{what}: {layer} off the chain's on {int(off.sum())} "
                                         f"of {n} lanes, more than 0.1 %")
            if not float(want[0].abs().sum()) > 0:
                raise AssertionError(f"{what}: the chain's L is all zero")
            for b, (active, hi, lo) in enumerate(states):
                st = chain(scene, dataclasses.replace(cfg, max_depth=b + 1), ray, s)[3].state
                bad = int((((hi != st.state_hi) | (lo != st.state_lo)) & active).sum())
                if bad:
                    raise AssertionError(f"{what}: after bounce {b} the pcg32 state of {bad} "
                                         "live lanes differs from the chain's")
            # the kernel alone per launch (folds included), and shade_ref per call
            ev = kernel_events(lambda: path_int.li_path_fused(scene, cfg, ray, s, sc), reps=3)
            k_ms = sum(v[0] for k, v in ev.items() if "shade_kernel" in k)
            k_n = sum(v[1] for k, v in ev.items() if "shade_kernel" in k)
            plain = []

            def timed_ref(sc_, lanes, bounce, hits, occ, fold_only=False):
                e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                e[0].record()
                scan_shade.shade_ref(sc_, lanes, bounce, hits, occ, fold_only)
                e[1].record()
                plain.append(e)

            path_int.li_path_fused(scene, cfg, ray, s, sc, shade=timed_ref)  # warm-up
            plain.clear()
            path_int.li_path_fused(scene, cfg, ray, s, sc, shade=timed_ref)
            torch.cuda.synchronize()
            row["ms"] = k_ms / k_n if k_n else "not measured"
            row["ms_per_render"] = k_ms if k_n else "not measured"
            row["launches_per_render"] = round(k_n)
            row["plain_ms"] = sum(a.elapsed_time(b) for a, b in plain) / len(plain)
            if integ == "path_mis":  # the fold's launch moves the pending terms alone
                nbytes = sum(k * SHADE_LIVE_BYTES + (n - k) * SHADE_DEAD_BYTES for k in live)
                row["bound"] = bound(0, nbytes / (len(live) + 1))
                row["bytes_per_render"] = nbytes
            rec[f"{name}_{integ}"] = row
            ms = row["ms"] if isinstance(row["ms"], str) else f"{row['ms']:.4f} ms"
            print(f"  {what} at {cfg.width}x{cfg.height}, depth {cfg.max_depth}: lanes off "
                  f"L {row['L_lanes_off']}, albedo {row['albedo_lanes_off']}, normal "
                  f"{row['normal_lanes_off']} of {n}, max |err| of L {row['L_max_abs_err']:.3e}; "
                  f"live lanes per bounce {live}; shade_kernel {ms} a launch "
                  f"({row['launches_per_render']} a render), shade_ref {row['plain_ms']:.3f} ms"
                  + (f", bound {row['bound'][0]:.4f} ms" if "bound" in row else "")
                  + f" on {smi}")
    phase(34, "the shading kernel equals the torch chain on configs A and B at 800x600 "
              f"(config A path_mis: {rec['config_a_path_mis']['ms']} ms a launch)")
    return rec


# ---- phase 35: the scan path's filter splat (csrc/film.cu)

FILM_SOURCE = "optix_renderer_tpu_torch/csrc/film.cu"
# bytes a splat must move: per lane its position (8 B) and three layer values
# (36 B) read once, and the [3, H, W, 4] float32 film read and written once
SPLAT_LANE_BYTES = 8 + 3 * 12
SPLAT_PIXEL_BYTES = 2 * 3 * 16


def film_splat(dev, smi: str, scene_a, cfg_a, scene_b, cfg_b) -> dict:
    """Phase 35: `splat_kernel` against the plain body `_splat_plain_` on one
    round of configs A (gaussian) and B (mitchell) as `render.scan_step`
    chunks it (padding lanes included, where it pads); the kernel's time per launch
    beside its bytes bound and the plain body's; its adjoint `splat_grad_kernel`
    against the plain body's autograd on a random film gradient, and its time
    beside its bound; returns the phase's record."""
    from optix_renderer_tpu_torch.ops.cuda import film as film_kernel
    from optix_renderer_tpu_torch.render import film as film_ops
    from optix_renderer_tpu_torch.render import render as render_mod
    from optix_renderer_tpu_torch.render import scan_graph

    rec = {}
    for name, scene, cfg in (("config_a", scene_a, cfg_a), ("config_b", scene_b, cfg_b)):
        n_pix = cfg.width * cfg.height
        pad = -n_pix % min(render_mod.MAX_LANES, n_pix)
        ids = torch.cat([torch.arange(n_pix), torch.full((pad,), -4 * max(cfg.width, cfg.height))])
        sc = scan_graph.shade_scene(scene, cfg, dev)
        pos, layers = render_mod._round_layers(scene, cfg, ids.to(dev), 7, sc)
        got = torch.zeros((3, cfg.height, cfg.width, 4), device=dev)
        want = torch.zeros_like(got)
        film_ops.splat_(got, cfg.rfilter, pos, layers)
        film_ops._splat_plain_(want, cfg.rfilter, pos, layers)
        # two orders of adds: tests/test_torch_scan_graph.py's _film_close, layer by layer
        err = (got - want).abs()
        scale = want.abs().amax(dim=(1, 2, 3), keepdim=True).clamp_min(1.0)
        over = int((err > 1e-5 * want.abs() + 1e-6 * scale).sum())
        if over or not float(want[0, ..., 3].min()) > 0:
            raise AssertionError(f"{name}: the splat kernel's film is off the plain body's on "
                                 f"{over} values")
        acc = torch.zeros_like(got)
        ev = kernel_events(lambda: film_ops.splat_(acc, cfg.rfilter, pos, layers), reps=5)
        k_ms = sum(v[0] for k, v in ev.items() if "splat_kernel" in k)
        k_n = sum(v[1] for k, v in ev.items() if "splat_kernel" in k)
        # where the profiler records no launch (it can lose them late in a whole run), CUDA
        # events around 20 back-to-back calls: the launches queue faster than they run
        timed_by = "profiler" if k_n else "cuda events"
        ms = k_ms / k_n if k_n else event_ms(
            lambda: film_ops.splat_(acc, cfg.rfilter, pos, layers), 20)
        n = pos.shape[0]
        nbytes = n * SPLAT_LANE_BYTES + n_pix * SPLAT_PIXEL_BYTES
        row = {"lanes": n, "rfilter": cfg.rfilter, "max_abs_err": float(err.max()),
               "max_rel_err": float((err / (want.abs() + 1e-6 * scale)).max()),
               "ms": ms, "timed_by": timed_by, "launches_per_call": round(k_n),
               "plain_ms": event_ms(lambda: film_ops._splat_plain_(acc, cfg.rfilter, pos,
                                                                   layers), 3),
               "bytes": nbytes, "bound": bound(0, nbytes)}
        # the adjoint (`splat`'s backward on a card) against the plain body's autograd
        gfilm = torch.randn(got.shape, device=dev, generator=torch.Generator(dev).manual_seed(9))
        g = film_kernel.splat_grad(gfilm, cfg.rfilter, pos)
        lay = layers.detach().clone().requires_grad_(True)
        plain = torch.zeros_like(got)
        film_ops._splat_plain_(plain, cfg.rfilter, pos, lay)
        (g_want,) = torch.autograd.grad((plain * gfilm).sum(), lay)
        g_err = float((g - g_want).abs().max())
        if g_err > 1e-5 * max(1.0, float(g_want.abs().max())):
            raise AssertionError(f"{name}: the adjoint is off the plain gradient by {g_err}")
        g_bytes = n * SPLAT_LANE_BYTES + n_pix * SPLAT_PIXEL_BYTES // 2  # the film read once
        row["grad"] = {"max_abs_err": g_err, "bytes": g_bytes, "bound": bound(0, g_bytes),
                       "ms": event_ms(lambda: film_kernel.splat_grad(gfilm, cfg.rfilter, pos), 20)}
        rec[name] = row
        print(f"  {name} {cfg.rfilter} round at {cfg.width}x{cfg.height} ({n} lanes): max |err| "
              f"{row['max_abs_err']:.3e}; splat_kernel {ms:.4f} ms a launch ({timed_by}), "
              f"plain body {row['plain_ms']:.3f} ms, bound {row['bound'][0]:.4f} ms; "
              f"splat_grad_kernel {row['grad']['ms']:.4f} ms a call (cuda events, its zeros "
              f"included), max |err| {g_err:.3e}, bound {row['grad']['bound'][0]:.4f} ms on {smi}",
              flush=True)
    phase(35, "the splat kernel's films equal the plain body's up to the order of adds on "
              f"configs A and B at 800x600 (config A: {rec['config_a']['ms']:.4f} ms a launch)")
    return rec


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
    from optix_renderer_tpu_torch.render.render import _layers_out, render
    from optix_renderer_tpu_torch.scene.presets import (
        cornell_box_xml,
        make_cornell_box,
        make_tessellated_cornell,
    )
    from optix_renderer_tpu_torch.tools.time_isect import (
        MAIN_RAYS,
        bounce_and_shadow_rays,
        brute_bound,
        brute_sets as brute_sets_of,
        camera_rays,
        config_a_rays,
        device_ms as spin_ms,
        library_sass,
        profiled_ms,
        ptxas_report,
        sweep_loops,
    )
    from optix_renderer_tpu_torch.tools.time_pathk import lane_efficiency, refill_efficiency
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
    small_regs = {k: v for k, v in ptxas_report(info.get("ptxas", "")).items()
                  if re.search(r"pathk_kernelILb[01]E", k)}
    if len(small_regs) != 2:
        raise AssertionError(f"ptxas reported {len(small_regs)} small-branch instances, not 2")
    print(f"  small branch pathk_kernel<MIS>: {small_regs}")

    # ---- 3. kernel vs plain version on the card, small Cornell
    for integ in ("path_mis", "path_mats"):
        scene, cfg, _ = make_cornell_box(64, 48, 4, integ, device=dev)
        cfg = dataclasses.replace(cfg, max_depth=4, rfilter="box")
        tables, meta = pathk.build_pathk_tables(scene, cfg, dev)
        n_pix = cfg.width * cfg.height
        got = pathk.pathk_trace(tables, meta, cfg, n_pix=n_pix, spp0=0, n_spp=4)
        small_launch = pathk.last_launch()
        ref = pathk.pathk_trace_ref(tables, meta, cfg, n_pix=n_pix, spp0=0, n_spp=4)
        torch.cuda.synchronize()
        compare(film(got, 48, 64), film(ref, 48, 64), 4, f"64x48 box {integ}")
        if not torch.equal(got, ref):
            raise AssertionError(f"64x48 box {integ}: rows differ from the plain version on "
                                 f"{int((got != ref).any(0).sum())} pixels")
        print(f"  64x48 box {integ}: rows bit-equal; launch {small_launch}")
    # the launcher refuses a launch without its pixel counter (a null
    # next_pix), and pathk_trace raises on any refusal
    lib = _build.load()
    vp = ctypes.c_void_p
    rc = lib.pathk_trace_launch(vp(0), vp(0), vp(0), vp(0), vp(0), 1, vp(0), 12, vp(0), 1,
                                vp(0), vp(0), 0, 8, 0, 100, 10, 0, 0, 1, 4, 1, 1, 1, 0, 0, vp(0),
                                vp(0))
    if rc == 0:
        raise AssertionError("the path kernel launched without its pixel counter")
    print(f"  a launch without its pixel counter returns {rc} ({_build.error_string(rc)})")
    phase(3, "kernel rows equal the plain version bit for bit (64x48, box, depth 4, 4 spp)")

    # ---- 4. golden images (tools/gen_golden.py config) through the kernel.
    # The goldens are splatted films; the kernel's film is filter-importance
    # sampled and noisier per pixel. path_mats (no NEE) at 8 spp gives a
    # per-pixel error of 0.6655 for the JAX path kernel too (see
    # tests/test_torch_pathk.py: test_golden_per_pixel_statistic_of_jax_kernel),
    # so its check runs on 4x4-pixel block means; path_mis is checked per pixel.
    for integ, block in (("path_mis", 1), ("path_mats", 4)):
        scene, cfg, _ = make_cornell_box(64, 48, 1, integ, device=dev)
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
    scene, cfg, _ = make_cornell_box(800, 600, 64, "path_mis", device=dev)
    cfg = dataclasses.replace(cfg, max_depth=16, rfilter="gaussian")
    render(scene, cfg, sample_count=16, device=dev)  # warm-up
    tracing.reset_counters("launch.pathk")
    torch.cuda.synchronize()
    t0 = time.time()
    out = render(scene, cfg, sample_count=64, device=dev)  # returns host numpy
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = tracing.counter("launch.pathk")
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
    if not torch.equal(got, ref):
        raise AssertionError(f"800x600: rows differ from the plain version on "
                             f"{int((got != ref).any(0).sum())} pixels")
    stats["max_abs_err"] = float((got - ref).abs().max())
    # the share of lane iterations that do work, from each pixel's iteration
    # count: warps of 32 fixed pixels, blocks of 128 that hold their slots
    # until the slowest warp ends (a fixed grid of one thread per pixel), and
    # the refill model at this launch's persistent grid
    main_launch = pathk.last_launch()
    it10 = got[10].cpu().numpy()
    lane_eff = {"warp32": lane_efficiency(it10, 32), "block128": lane_efficiency(it10, 128),
                "refill_model": refill_efficiency(
                    it10, main_launch["blocks"] * main_launch["threads"] // 32)}
    print(f"  800x600 launch {main_launch}: lane efficiency {json.dumps(lane_eff)}")
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
    scene_a, cfg_a, _ = make_tessellated_cornell(800, 600, 4, "path_mis", device=dev)
    cfg_a = dataclasses.replace(cfg_a, max_depth=8, rfilter="gaussian")
    geom_a = scene_a.geometry.to(dev)
    tree = geom_a.bvh
    packed, pairs, leaf = tree.packed, tree.pairs, tree.leaf
    print(f"  config A: {cfg_a.n_tris} triangles, {packed.shape[0]} nodes, {pairs.shape[0]} pair "
          f"rows, {leaf.shape[0]} leaves, {tree.depth} levels, built in {time.time() - t0:.2f} s")
    # the main path's width: 480,000 camera rays, and 480,000 bounce and
    # shadow rays each from the hits of 600,000 further camera rays
    prim_a, bounce_a, shadow_a = config_a_rays(lambda *r: isect.isect_bvh(tree, *r), scene_a,
                                               cfg_a, rng, dev)
    ref, plain_closest = timed(lambda: bvh.traverse_pairs_ref(pairs, leaf, *prim_a))
    err_bvh = gate_closest("isect_bvh closest, camera rays", isect.isect_bvh(tree, *prim_a), ref)
    err_bvh = max(err_bvh, gate_closest("isect_bvh closest, bounce rays",
                                        isect.isect_bvh(tree, *bounce_a),
                                        bvh.traverse_pairs_ref(pairs, leaf, *bounce_a)))
    ref, plain_any = timed(lambda: bvh.traverse_pairs_ref(pairs, leaf, *shadow_a, any_hit=True))
    err_any = gate_any("isect_bvh any, shadow rays",
                       isect.isect_bvh(tree, *shadow_a, any_hit=True), ref)
    print(f"  plain walk, {MAIN_RAYS} rays: closest {plain_closest:.3f} ms, "
          f"any {plain_any:.3f} ms on {smi}")
    # the launcher refuses a launch without its ray counter (a null next_ray)
    vp = ctypes.c_void_p
    rc = _build.load().isect_bvh_launch(vp(pairs.data_ptr()), vp(leaf.data_ptr()), vp(0), vp(0),
                                        vp(0), vp(0), 1, 0, vp(0), vp(0), vp(0), vp(0), vp(0),
                                        vp(0), vp(0))
    if rc == 0:
        raise AssertionError("isect_bvh launched without its ray counter")
    print(f"  an isect_bvh launch without its ray counter returns {rc} "
          f"({_build.error_string(rc)})")
    scene_b, cfg_b, _ = make_cornell_box(800, 600, 4, "path_mis", device=dev)
    cfg_b = dataclasses.replace(cfg_b, max_depth=16, rfilter="mitchell")
    # isect_brute at 480,000 rays against 12, 64 and 252 triangles: id, t, u
    # and v equal to the plain version's on every ray (the sweep's
    # arithmetic is mt_sweep_ref's, built without FMA contraction); then one
    # set again from arrays that are not 16-byte aligned, which the wrapper
    # sends to the instantiation that reads one float at a time
    brute_sets = brute_sets_of(isect, dev, rng)

    def brute_equal(what, tri, rays):
        got = isect.isect_brute(tri, *rays)
        ref = isect.mt_sweep_ref(*rays, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
        torch.cuda.synchronize()
        bad = [int((a != b).sum()) for a, b in zip(got, ref)]
        print(f"  isect_brute, {what}: {rays[0].shape[0]} rays x {tri.shape[0]} triangles, hits "
              f"{float((ref[0] >= 0).float().mean()):.4f}, rays whose id, t, u, v differ from "
              f"the plain version {bad}; launch {isect.last_launch('brute')}", flush=True)
        if any(bad):
            raise AssertionError(f"isect_brute, {what}: differs from mt_sweep_ref on {bad} rays")
        return float((got[1] - ref[1]).abs().max())

    err_brute = max(brute_equal(name, tri, rays) for name, (tri, rays) in brute_sets.items())
    # the sweep's in-line reciprocal equals `1.0f / x` on every float where
    # it is used (all 2^32 bit patterns are visited)
    rcp = isect.rcp_check(dev)
    print(f"  in-line reciprocal (csrc/walk.cuh: rcp_fast) against 1.0f / x: {rcp}")
    if not (rcp["tested"] == 2**32 - 2**26 and rcp["differ"] == 0):
        raise AssertionError(f"rcp_fast differs from 1.0f / x: {rcp}")

    def unaligned(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        return view

    tri_252, rays_252 = brute_sets["t252_camera"]
    brute_equal("t252_camera from unaligned arrays", tri_252,
                tuple(unaligned(x) for x in rays_252))
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
    tracing.reset_counters("launch.isect_")
    tracing.reset_counters("launch.scan_")
    tracing.reset_counters("launch.film_")
    torch.cuda.synchronize()
    t0 = time.time()
    out_a = render(scene_a, cfg_a, sample_count=4, device=dev)  # returns host numpy
    dt_a = time.time() - t0
    launches_a = launches_of(ISECT_KERNELS)
    shade_launches_a = launches_of(SCAN_KERNELS)
    splat_launches_a = tracing.counter("launch.film_splat")
    comp = out_a["composite"]
    print(f"  config A 800x600 path_mis depth 8 gaussian, 4 spp: {dt_a:.4f} s, "
          f"{800 * 600 * 4 / dt_a / 1e6:.4f} Mpaths/s on {smi}; launches {launches_a}; "
          f"film mean {comp.mean():.5f}")
    if not (launches_a["isect_bvh_closest"] > 0 and launches_a["isect_bvh_any"] > 0):
        raise AssertionError(f"config A launched an LBVH kernel no time: {launches_a}")
    print(f"  config A shading kernel launches: {shade_launches_a}")
    if shade_launches_a != {"scan_shade": 4 * cfg_a.max_depth, "scan_fold": 4}:
        raise AssertionError(f"config A's 4 spp at depth {cfg_a.max_depth} did not take the "
                             f"shading kernel once a bounce: {shade_launches_a}")
    if splat_launches_a != 4:  # one chunk of 2^19 lanes a round
        raise AssertionError(f"config A's 4 spp took the splat kernel {splat_launches_a} times, "
                             "not once a round")
    if not (np.isfinite(comp).all() and comp.shape == (600, 800, 3) and comp.mean() > 0):
        raise AssertionError("config A film is not finite / positive")
    scene_q, cfg_q, _ = make_tessellated_cornell(400, 300, 1, "path_mis", device=dev)
    cfg_q = dataclasses.replace(cfg_q, max_depth=8)
    render(scene_q, cfg_q, sample_count=4, device=dev)  # warm-up, as bench.py's _run
    t0 = time.time()
    out_q = render(scene_q, cfg_q, sample_count=4, device=dev)
    dt_q = time.time() - t0
    print(f"  bench.py mesh100k config 400x300 path_mis depth 8, 4 spp: {dt_q:.4f} s, "
          f"{400 * 300 * 4 / dt_q / 1e6:.4f} Mpaths/s on {smi}; film mean "
          f"{out_q['composite'].mean():.5f}")
    # one launch each on phase 7's rays: closest hit on the 480,000 camera
    # rays and on the 480,000 bounce rays, any hit on the 480,000 shadow
    # rays; device time behind a spin (tools/time_isect.py: device_ms),
    # median of 7, and the pair rows read and leaves tested per ray
    bvh_regs = {k: v for k, v in ptxas_report(info.get("ptxas", "")).items()
                if re.search(r"isect10bvh_kernelILb[01]ENS_7TriLeaf", k)}
    if len(bvh_regs) != 2:
        raise AssertionError(f"ptxas reported {len(bvh_regs)} bvh_kernel instances, not 2")
    print(f"  isect_bvh bvh_kernel<ANY>: {bvh_regs}")
    table_bytes = (packed.numel() + leaf.numel()) * 4

    def walk_bound(visits, ops_node, node_bytes):
        """(bound: the operations the walk does on these rays, `ops_node`
        per node or pair row read, against the bytes the function must
        move, rays in and out and the LBVH's tables read once; the time of
        every row and leaf read from device memory, which the L2-resident
        tables mostly avoid)"""
        nodes, leaves = (float(x) for x in visits.double().sum(dim=1))
        n_rays = visits.shape[1]
        need = bound(nodes * ops_node + leaves * 4 * (OPS_MT + 1) + n_rays * OPS_RAY,
                     n_rays * RAY_BYTES + table_bytes)
        return need, (nodes * node_bytes + leaves * 160) / PEAK_BYTES * 1e3

    bvh_rows = {}
    for key, rays, any_hit in (("closest_camera", prim_a, False),
                               ("closest_bounce", bounce_a, False),
                               ("any_shadow", shadow_a, True)):
        vis = isect.isect_bvh(tree, *rays, any_hit=any_hit, with_visits=True)[4]
        ms = float(np.median(spin_ms(lambda: isect.isect_bvh(tree, *rays, any_hit=any_hit), 7)))
        # the yardstick stays the skip-link walk's (the parent kernel's) on
        # the same rays; the pair walk's own count is printed beside it
        skip_vis = bvh.traverse_walk_ref(packed, leaf, *rays, any_hit=any_hit,
                                         with_visits=True)[4]
        (b_skip, _), (b_pair, visit_ms) = (walk_bound(skip_vis, OPS_SLAB, 32),
                                           walk_bound(vis, OPS_PAIR, 64))
        bvh_rows[key] = {"ms": ms, "bound": b_skip, "visit_bytes_hbm_ms": visit_ms,
                         "pair_walk_bound_ms": b_pair[0],
                         "rows_per_ray": float(vis[0].double().mean()),
                         "leaves_per_ray": float(vis[1].double().mean()),
                         "skip_walk_nodes_per_ray": float(skip_vis[0].double().mean()),
                         "skip_walk_leaves_per_ray": float(skip_vis[1].double().mean()),
                         "launch": isect.last_launch()}
        r = bvh_rows[key]
        print(f"  isect_bvh {key}, {MAIN_RAYS} rays: {ms:.4f} ms (bound {b_skip[0]:.4f} ms, "
              f"{b_skip[1]}, from the skip-link walk's {r['skip_walk_nodes_per_ray']:.1f} nodes and "
              f"{r['skip_walk_leaves_per_ray']:.2f} leaves per ray; the pair walk's own "
              f"{r['rows_per_ray']:.1f} rows and {r['leaves_per_ray']:.2f} leaves give "
              f"{b_pair[0]:.4f} ms; every visit from device memory {visit_ms:.4f} ms); launch "
              f"{r['launch']} on {smi}")
    ms_closest, ms_any = bvh_rows["closest_camera"]["ms"], bvh_rows["any_shadow"]["ms"]
    # where the time of a config A sample goes: device time by kernel and the
    # device's idle share of the wall clock
    pa = device_breakdown(lambda: render(scene_a, cfg_a, sample_count=1, device=dev))
    print(f"  config A, 1 spp under the profiler: wall {pa['wall_s']:.4f} s, device busy "
          f"{pa['device_busy_s']:.4f} s in {pa['kernels']} kernels, idle share "
          f"{pa['idle_share']:.4f}; top device time (ms): "
          + "; ".join(f"{k} {v:.3f}" for k, v in pa["top_ms"].items()))
    phase(8, f"config A: {800 * 600 * 4 / dt_a / 1e6:.4f} Mpaths/s, launches {launches_a}")

    # ---- 9. config B through render(): the brute-force kernel on the main path
    render(scene_b, cfg_b, sample_count=1, device=dev)  # warm-up
    tracing.reset_counters("launch.isect_")
    torch.cuda.synchronize()
    t0 = time.time()
    out_b = render(scene_b, cfg_b, sample_count=4, device=dev)
    dt_b = time.time() - t0
    launches_b = launches_of(ISECT_KERNELS)
    comp = out_b["composite"]
    print(f"  config B 800x600 mitchell path_mis depth 16, 4 spp: {dt_b:.4f} s, "
          f"{800 * 600 * 4 / dt_b / 1e6:.4f} Mpaths/s on {smi}; launches {launches_b}; "
          f"film mean {comp.mean():.5f}")
    if not launches_b["isect_brute"] > 0:
        raise AssertionError(f"config B launched isect_brute no time: {launches_b}")
    if not (np.isfinite(comp).all() and comp.shape == (600, 800, 3) and comp.mean() > 0):
        raise AssertionError("config B film is not finite / positive")
    # config B-252: the same at 252 triangles, still below the LBVH's 257
    scene_b252, cfg_b252, _ = make_tessellated_cornell(800, 600, 4, "path_mis", nu=10, nv=7,
                                                       device=dev)
    cfg_b252 = dataclasses.replace(cfg_b252, max_depth=16, rfilter="mitchell")
    render(scene_b252, cfg_b252, sample_count=1, device=dev)  # warm-up
    tracing.reset_counters("launch.isect_")
    torch.cuda.synchronize()
    t0 = time.time()
    out_b252 = render(scene_b252, cfg_b252, sample_count=4, device=dev)
    dt_b252 = time.time() - t0
    launches_b252 = launches_of(ISECT_KERNELS)
    comp = out_b252["composite"]
    print(f"  config B-252 800x600 mitchell path_mis depth 16, 4 spp: {dt_b252:.4f} s, "
          f"{800 * 600 * 4 / dt_b252 / 1e6:.4f} Mpaths/s on {smi}; launches {launches_b252}; "
          f"film mean {comp.mean():.5f}")
    if not (launches_b252["isect_brute"] > 0 and launches_b252["isect_bvh_closest"] == 0):
        raise AssertionError(f"config B-252 did not take isect_brute: {launches_b252}")
    if not (np.isfinite(comp).all() and comp.shape == (600, 800, 3) and comp.mean() > 0):
        raise AssertionError("config B-252 film is not finite / positive")
    # the kernel on phase 7's sets: device time behind a spin, median of 7,
    # beside its bound; ptxas' registers and spills of its instances and
    # the launch's grid
    brute_regs = {k: v for k, v in ptxas_report(info.get("ptxas", "")).items()
                  if "brute_kernel" in k}
    if not brute_regs:
        raise AssertionError("ptxas reported no brute_kernel instance")
    print(f"  isect_brute brute_kernel: {brute_regs}")
    # instructions per ray-triangle pair on the sweep loops' fast path (SASS)
    brute_loops = {k: [round(lp["per_pair"], 2) for lp in v]
                   for k, v in sweep_loops(library_sass(info["path"])).items()}
    print(f"  isect_brute instructions per ray-triangle pair (tiled, resident loop): {brute_loops}")
    brute_rows = {}
    for name, (tri, rays) in brute_sets.items():
        ms = float(np.median(spin_ms(lambda: isect.isect_brute(tri, *rays), 7)))
        brute_rows[name] = {"ms": ms, **brute_bound(rays[0].shape[0], tri.shape[0]),
                            "launch": isect.last_launch("brute")}
        r = brute_rows[name]
        print(f"  isect_brute {name}, {rays[0].shape[0]} rays x {tri.shape[0]} triangles: "
              f"{ms:.4f} ms (bound {r['bound_ms']:.4f} ms, {r['bound_by']}; without FMA "
              f"{r['fmad_free_ms']:.4f} ms); launch {r['launch']} on {smi}")
    # at the main path's 12 triangles: the kernel alone (torch.profiler),
    # the whole wrapper call and the plain version
    tri_b, prim_b = brute_sets["t12_camera"]
    b_brute = (brute_rows["t12_camera"]["bound_ms"], brute_rows["t12_camera"]["bound_by"])
    ms_brute = profiled_ms(lambda: isect.isect_brute(tri_b, *prim_b), 7, "brute_kernel")
    wrapper_brute = event_ms(lambda: isect.isect_brute(tri_b, *prim_b), reps=5)
    plain_brute = event_ms(lambda: isect.mt_sweep_ref(*prim_b, tri_b[:, 0:3], tri_b[:, 3:6],
                                                      tri_b[:, 6:9]))
    print(f"  isect_brute t12_camera: kernel {ms_brute:.4f} ms (torch.profiler), whole "
          f"wrapper call {wrapper_brute:.4f} ms; plain version {plain_brute:.3f} ms on {smi}")
    phase(9, f"config B: {800 * 600 * 4 / dt_b / 1e6:.4f} Mpaths/s, launches {launches_b}; "
             f"config B-252: {800 * 600 * 4 / dt_b252 / 1e6:.4f} Mpaths/s, launches {launches_b252}")

    # ---- 10. the general path against the goldens (tools/gen_golden.py config)
    for integ in ("path_mis", "path_mats"):
        hold_golden(integ, dev)
    phase(10, "the scan path reproduces the goldens")

    # ---- 11. the path kernel's medium branch vs its plain version
    from optix_renderer_tpu_torch.scene.build import load_scene
    from optix_renderer_tpu_torch.scene.presets import tessellated_cornell_xml

    for name, rep_ in ptxas_report(info.get("ptxas", "")).items():
        if "pathk" in name or "probes" in name:
            print(f"  ptxas {name}: {rep_}")
    medium_regs = {k: v for k, v in ptxas_report(info.get("ptxas", "")).items()
                   if re.search(r"pathk_staged_kernelILb[01]E", k)}
    if len(medium_regs) != 2:
        raise AssertionError(f"ptxas reported {len(medium_regs)} medium instances, not 2")

    def rows_equal(tables, meta, cfg, n_pix, n_spp, what):
        """The medium kernel's rows against the plain version's, bit for
        bit; prints the films' statistics, returns max |kernel − plain|."""
        got = pathk.pathk_trace(tables, meta, cfg, n_pix=n_pix, spp0=0, n_spp=n_spp)
        ref = pathk.pathk_trace_ref(tables, meta, cfg, n_pix=n_pix, spp0=0, n_spp=n_spp)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"{what}: rows differ from the plain version on "
                                 f"{int((got != ref).any(0).sum())} pixels")
        h = n_pix // cfg.width
        compare(film(got, h, cfg.width), film(ref, h, cfg.width), n_spp, what)
        return float((got - ref).abs().max())

    err_medium = 0.0
    for integ in ("path_mis", "path_mats"):
        scene_m, cfg_m, _ = make_tessellated_cornell(160, 120, 4, integ, nu=40, nv=51,
                                                     device=dev)
        cfg_m = dataclasses.replace(cfg_m, max_depth=4, rfilter="box")
        tables, meta = pathk.build_pathk_tables(scene_m, cfg_m, dev)
        if not meta["t_cnt"] == 8012 > pathk.VPU_MAX_TRIS:
            raise AssertionError(f"config M is not the 8,012-triangle medium branch: {meta}")
        err_medium = max(err_medium, rows_equal(tables, meta, cfg_m, 160 * 120, 4,
                                                f"config M 160x120 box {integ}"))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        scene_s, cfg_s, _ = load_scene(strip_room_xml(Path(tmp)), dev)
    cfg_s = dataclasses.replace(cfg_s, max_depth=4, rfilter="box")
    tables, meta = pathk.build_pathk_tables(scene_s, cfg_s, dev)
    if not (meta["t_cnt"] == 70 > pathk.VPU_MAX_TRIS and meta["n_sph"] == 1
            and scene_s.geometry.bvh is None and meta["n_nodes"] == 35):
        raise AssertionError(f"the strip room is not a 70-triangle medium scene whose LBVH the "
                             f"table packing built: {meta}")
    err_medium = max(err_medium, rows_equal(tables, meta, cfg_s, 64 * 48, 4,
                                            "strip room 64x48 box path_mis"))
    phase(11, "the medium branch equals its plain version bit for bit (config M geometry "
              f"160x120, strip room 64x48); medium instances {medium_regs}")

    # ---- 12. config M through render(): the medium branch on the main path
    scene_m, cfg_m, _ = make_tessellated_cornell(800, 600, 16, "path_mis", nu=40, nv=51,
                                                 device=dev)
    cfg_m = dataclasses.replace(cfg_m, max_depth=16, rfilter="gaussian")
    render(scene_m, cfg_m, sample_count=1, device=dev)  # warm-up
    tracing.reset_counters("launch.")
    torch.cuda.synchronize()
    t0 = time.time()
    out_m = render(scene_m, cfg_m, sample_count=16, device=dev)  # returns host numpy
    dt_m = time.time() - t0
    launches_m, isect_m = tracing.counter("launch.pathk"), launches_of(ISECT_KERNELS)
    comp = out_m["composite"]
    print(f"  config M 800x600 path_mis depth 16 gaussian, 16 spp: {dt_m:.4f} s, "
          f"{800 * 600 * 16 / dt_m / 1e6:.4f} Mpaths/s on {smi}; path kernel launches "
          f"{launches_m}, intersection kernel launches {isect_m}; film mean {comp.mean():.5f}")
    if launches_m < 1 or any(isect_m.values()):
        raise AssertionError(f"config M did not take the path kernel alone: {launches_m}, {isect_m}")
    if not (np.isfinite(comp).all() and comp.shape == (600, 800, 3) and comp.mean() > 0
            and (out_m["weights"] == 16).all()):
        raise AssertionError("config M film is not finite / positive / 16 spp")
    tables, meta = pathk.build_pathk_tables(scene_m, cfg_m, dev)
    n_pix = 800 * 600
    got = pathk.pathk_trace(tables, meta, cfg_m, n_pix=n_pix, spp0=0, n_spp=16)
    medium_ms = event_ms(lambda: pathk.pathk_trace(tables, meta, cfg_m, n_pix=n_pix, spp0=0,
                                                   n_spp=16), reps=3)
    iters_m = float(got[10].double().sum())
    # the bound of the old algorithm, a sweep over all triangles per iteration
    sweep_bound = bound(iters_m * (meta["t_cnt"] * OPS_MT + meta["n_sph"] * OPS_SPHERE + 5),
                        16 * 4 * n_pix)
    # the plain version traces pixels [0, n_ref) of the same 800x600 tables;
    # every pixel runs on its own, so they must equal the full launch's
    n_ref = 800 * M_REF_ROWS
    ref_m, medium_plain_ms = timed(lambda: pathk.pathk_trace_ref(tables, meta, cfg_m, n_pix=n_ref,
                                                                 spp0=0, n_spp=16))
    _, medium_ref_ms = timed(lambda: pathk.pathk_trace(tables, meta, cfg_m, n_pix=n_ref, spp0=0,
                                                       n_spp=16))
    if not torch.equal(got[:, :n_ref], ref_m):
        raise AssertionError(f"config M rows 0-{M_REF_ROWS - 1}: the kernel differs from the plain "
                             f"version on {int((got[:, :n_ref] != ref_m).any(0).sum())} pixels")
    st_m = compare(film(got[:, :n_ref], M_REF_ROWS, 800), film(ref_m, M_REF_ROWS, 800), 16,
                   f"config M 800x600 gaussian depth 16, rows 0-{M_REF_ROWS - 1}")
    err_medium = max(err_medium, float((got[:, :n_ref] - ref_m).abs().max()))
    # the bound of the function as the kernel computes it: an LBVH walk per
    # iteration, at the nodes and leaves per closest hit counted on config
    # M's own camera and bounce rays (the shadow rays' any-hit walks are
    # left out, so this is a lower bound)
    rng_m = np.random.default_rng(12)
    geom_m = scene_m.geometry.to(dev)
    packed_m, leaf_m = geom_m.bvh.packed, geom_m.bvh.leaf
    cam_m = camera_rays(scene_m, cfg_m, MAIN_RAYS, rng_m, dev)
    first_m = bvh.traverse_walk_ref(packed_m, leaf_m, *cam_m, with_visits=True)
    bounce_m, _ = bounce_and_shadow_rays(geom_m, cam_m, first_m[0], first_m[1], rng_m)
    vis_m = torch.cat([first_m[4], bvh.traverse_walk_ref(packed_m, leaf_m, *bounce_m,
                                                         with_visits=True)[4]], dim=1)
    nodes_m, leaves_m = (float(x) for x in vis_m.double().mean(dim=1))
    walk_ray_ops = nodes_m * OPS_SLAB + leaves_m * 4 * (OPS_MT + 1) + OPS_RAY
    walk_bound = bound(iters_m * (walk_ray_ops + meta["n_sph"] * OPS_SPHERE + 5), 16 * 4 * n_pix)
    print(f"  config M kernel, 800x600 x 16 spp: {medium_ms:.3f} ms; LBVH-walk bound "
          f"{walk_bound[0]:.4f} ms ({walk_bound[1]}) at {walk_ray_ops:.0f} operations per ray, "
          f"{nodes_m:.1f} nodes and {leaves_m:.2f} leaves; "
          f"the old sweep's bound {sweep_bound[0]:.3f} ms; {iters_m:.0f} iterations, "
          f"{iters_m / n_pix / 16:.3f} per sample; rows 0-{M_REF_ROWS - 1}: kernel "
          f"{medium_ref_ms:.3f} ms, plain version {medium_plain_ms:.3f} ms, bit-equal, on {smi}")
    phase(12, f"config M: {800 * 600 * 16 / dt_m / 1e6:.4f} Mpaths/s, {launches_m} launches")

    # ---- 13. the CLI on config M
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        xml = tessellated_cornell_xml(tmp, 160, 120, 4, "path_mis", nu=40, nv=51)
        subprocess.run([sys.executable, "-m", "optix_renderer_tpu_torch", "render", str(xml),
                        "--device", "cuda", "--spp", "4", "--size", "160x120"],
                       cwd=ROOT, check=True, timeout=600)
        exr, png = xml.with_suffix(".exr"), xml.with_suffix(".png")
        img = read_exr(exr)
        if not (png.stat().st_size > 0 and img.shape == (120, 160, 3) and np.isfinite(img).all()
                and img.mean() > 0):
            raise AssertionError("CLI output for config M is missing or malformed")
    phase(13, "CLI rendered config M on cuda and wrote EXR + PNG")

    # ---- 14. the probes: their entry points, then kernel vs plain version
    from optix_renderer_tpu_torch.tools import probe_copy, prof_parts
    from optix_renderer_tpu_torch.tools.time_probes import alone_ms

    tracing.reset_counters("launch.probe_copy")
    tracing.reset_counters("launch.iter_cost")
    pc = probe_copy.run(dev)
    parts = prof_parts.run(dev)
    launches_pc = tracing.counter("launch.probe_copy")
    launches_ic = tracing.counter("launch.iter_cost")
    if not (launches_pc >= 1 and launches_ic >= 1):
        raise AssertionError(f"a probe launched its kernel no time: {launches_pc}, {launches_ic}")
    if not (pc["rows_equal"] and pc["max_err"] <= 1e-6 * max(1.0, pc["scale"])):
        raise AssertionError(f"probe_copy against the probe's numpy reference: {pc['max_err']}")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def spread(cta_info, cluster):
        """The distinct SMs of a launch's CTAs; every CTA must sit in a
        cluster of `cluster` CTAs."""
        rows = cta_info.cpu().numpy()
        sizes = sorted(set(rows[:, 1].tolist()))
        if sizes != [cluster]:
            raise AssertionError(f"CTAs ran in clusters of {sizes}, not {cluster}")
        return int(len(set(rows[:, 0].tolist())))

    # probe_copy: bit for bit, its CTAs' SMs and clusters, then its times
    x, sel = probe_copy.make_inputs(dev)
    got = probe_copy.probe_copy(x, sel)
    ref = probe_copy.probe_copy_ref(x, sel)
    err_pc = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"probe_copy kernel vs plain: max err {err_pc}, not 0")
    pc_out = torch.empty_like(got)
    pc_info = torch.zeros((probe_copy.CTAS, 2), dtype=torch.int32, device=dev)
    probe_copy._launch(x, sel, pc_out, info=pc_info)
    pc_sms = spread(pc_info, 8)
    if not (torch.equal(pc_out, ref) and pc_sms > 8):
        raise AssertionError(f"probe_copy with its CTAs recorded: {pc_sms} SMs")
    launch_pc = lambda: probe_copy._launch(x, sel, pc_out)
    empty = lambda: probe_copy.empty_launch(dev)
    yardstick = lambda: probe_copy.torch_yardstick(x, sel)
    pc_spin_ms = prof_parts.kernel_ms(launch_pc, reps=20)
    floor_spin_ms = prof_parts.kernel_ms(empty, reps=20)
    pc_alone = {name: alone_ms(fn, 20, kernel) for name, fn, kernel in
                (("kernel", launch_pc, "probe_copy_kernel"), ("floor", empty, "empty_kernel"),
                 ("yardstick", yardstick, ""))}
    # where torch.profiler records no device time for the kernel (it has
    # happened for the probes), its time is the one behind a spin
    pc_ms = pc_alone["kernel"] or pc_spin_ms
    pc_wrapper_ms = event_ms(lambda: probe_copy.probe_copy(x, sel), reps=20)
    pc_plain_ms = event_ms(lambda: probe_copy.probe_copy_ref(x, sel))
    n_flag = sum(probe_copy.flags())
    pc_bound = bound(n_flag * probe_copy.CS * probe_copy.W,
                     n_flag * probe_copy.CS * probe_copy.W * 4 + probe_copy.C * 4
                     + probe_copy.OUT_ROWS * probe_copy.W * 4)
    print(f"  probe_copy: equal to plain; {probe_copy.CTAS} CTAs in clusters of 8 on {pc_sms} "
          f"SMs; kernel alone {pc_alone['kernel']:.5f} ms, behind a spin {pc_spin_ms:.5f} ms "
          f"(bound {pc_bound[0]:.5f} ms, {pc_bound[1]}); an empty kernel in its grid "
          f"{pc_alone['floor']:.5f} ms alone, {floor_spin_ms:.5f} behind a spin; torch "
          f"yardstick (index_select + two sums, several calls) {pc_alone['yardstick']:.5f} ms; "
          f"whole wrapper call {pc_wrapper_ms:.4f} ms, plain {pc_plain_ms:.3f} ms on {smi}")

    # iter_cost: every mode bit for bit at 64 and 1,024 iterations, with its
    # CTAs' SMs; reduce launches its groups as clusters of 4 CTAs
    x, tri = prof_parts.make_inputs(dev)
    ic_plain, ic_sms, err_ic = {}, {}, 0.0
    for mode in prof_parts.MODES:
        for n_it in prof_parts.ITERS:
            got = prof_parts.iter_cost(x, tri, n_it, mode)
            ref, plain_ms = timed(lambda: prof_parts.iter_cost_ref(x, tri, n_it, mode))
            err_ic = max(err_ic, float((got - ref).abs().max()))
            if not torch.equal(got, ref):
                raise AssertionError(f"iter_cost {mode} at {n_it} iterations vs plain: max err "
                                     f"{err_ic}, not 0")
            if n_it == 64:
                ic_plain[mode] = plain_ms
        before = tracing.counter("launch.iter_cost")
        ic_info = torch.zeros((prof_parts.NB * prof_parts.CTAS, 2), dtype=torch.int32,
                              device=dev)
        prof_parts.iter_cost(x, tri, 64, mode, info=ic_info)
        torch.cuda.synchronize()
        if tracing.counter("launch.iter_cost") != before + 1:
            raise AssertionError(f"iter_cost {mode}: the launch was not counted")
        ic_sms[mode] = spread(ic_info, prof_parts.CTAS if mode == "reduce" else 1)
        if mode != "reduce" and ic_sms[mode] < min(128, n_sm):
            raise AssertionError(f"iter_cost {mode} ran on {ic_sms[mode]} SMs")
        r = parts[mode]
        print(f"  iter_cost {mode}: t64 {r['ms'][64]:.4f} ms, t1024 {r['ms'][1024]:.4f} ms, "
              f"marginal {r['us_per_iter']:.5f} us/iteration, {r['us_per_block_iter']:.6f} "
              f"us/block-iteration, {r['ns_per_lane_iter']:.7f} ns/lane-iteration; plain at 64 "
              f"iterations {ic_plain[mode]:.3f} ms; equal to plain at 64 and 1,024 iterations; "
              f"{prof_parts.NB * prof_parts.CTAS} CTAs on {ic_sms[mode]} SMs on {smi}")
    lanes = prof_parts.NB * prof_parts.LANES
    # the shadow ray is the current ray (as in tools/prof_parts2.py), so one
    # test per triangle plus the shadow's two range checks, the ray (2) and
    # the acc update (6); the library is built without FMA, so its
    # operations run at half the FP32 peak at most; the issue limit counts
    # the built loop's instructions per lane-triangle
    ic_ops = 64 * lanes * (prof_parts.TRIS * (OPS_MT + 2) + 8)
    ic_bytes = lanes * 4 + tri.numel() * 4 + 8 * lanes * 4
    ic_bound = bound(ic_ops, ic_bytes)
    ic_half = bound(2 * ic_ops, ic_bytes)[0]
    ic_per_pair = prof_parts.isect_per_pair(library_sass(info["path"]))
    ic_issue = prof_parts.issue_limit_ms(ic_per_pair, 64) if ic_per_pair else None
    print(f"  iter_cost isect at 64 iterations: bound {ic_bound[0]:.4f} ms ({ic_bound[1]}), "
          f"{ic_half:.4f} ms at half the FP32 rate; {ic_per_pair} instructions per "
          f"lane-triangle, issue limit {ic_issue} ms at 1,980 MHz")
    phase(14, f"probes equal their plain versions; launches probe_copy {launches_pc}, "
              f"iter_cost {launches_ic}")

    # ---- 15. the single-bounce integrators and the surface features on the scan path
    from optix_renderer_tpu_torch.scene.presets import textured_cornell_xml

    def scan_render(scene, cfg, spp, warm=1):
        """(film, s, isect launches) of one timed `render()` after a warm-up,
        the counts set to 0 just before it and read just after."""
        if warm:
            render(scene, cfg, sample_count=warm, device=dev)
        tracing.reset_counters("launch.isect_")
        torch.cuda.synchronize()
        t0 = time.time()
        out = render(scene, cfg, sample_count=spp, device=dev)  # returns host numpy
        return out, time.time() - t0, launches_of(ISECT_KERNELS)

    # isect_brute launches per sample of the one 480,000-pixel chunk: one per
    # closest-hit trace and one per shadow ray (integrators/simple.py)
    per_sample = {"normals": 1, "av": 2, "direct": 2, "direct_ems": 2, "direct_mats": 2,
                  "direct_mis": 3, "preview": 2, "envmaptester": 0}
    slice_runs = {}
    scene_c, cfg_c, _ = make_cornell_box(800, 600, 4, device=dev)
    for integ, k in per_sample.items():
        cfg = dataclasses.replace(cfg_c, integrator=integ)
        if pathk.pathk_eligible(scene_c, cfg):
            raise AssertionError(f"the path kernel took the Cornell box with {integ}")
        out, dt, ln = scan_render(scene_c, cfg, 4)
        comp = out["composite"]
        slice_runs[f"cornell_{integ}"] = {"s": dt, "mpaths_s": 800 * 600 * 4 / dt / 1e6,
                                          "launches": ln, "film_mean": float(comp.mean())}
        print(f"  Cornell 800x600 {integ}, 4 spp: {dt:.4f} s, {800 * 600 * 4 / dt / 1e6:.4f} "
              f"Mpaths/s on {smi}; launches {ln}; film mean {comp.mean():.5f}")
        if ln["isect_brute"] != 4 * k or ln["isect_bvh_closest"] or ln["isect_bvh_any"]:
            raise AssertionError(f"Cornell {integ}: launches {ln}, expected isect_brute {4 * k}")
        if not (np.isfinite(comp).all() and comp.shape == (600, 800, 3)
                and (comp.mean() > 0) == (integ != "envmaptester")):
            raise AssertionError(f"Cornell {integ}: the film is not finite / as expected")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        scene_t, cfg_t, _ = load_scene(textured_cornell_xml(Path(tmp), 800, 600, 4), dev)
    if pathk.pathk_eligible(scene_t, cfg_t) or not scene_t.shapes.mapped:
        raise AssertionError("config T is not the textured scene of the scan path")
    for integ in ("direct_mis", "path_mis"):
        out, dt, ln = scan_render(scene_t, dataclasses.replace(cfg_t, integrator=integ), 4)
        comp = out["composite"]
        slice_runs[f"config_t_{integ}"] = {"s": dt, "mpaths_s": 800 * 600 * 4 / dt / 1e6,
                                           "launches": ln, "film_mean": float(comp.mean())}
        print(f"  config T 800x600 {integ} depth {cfg_t.max_depth}, 4 spp: {dt:.4f} s, "
              f"{800 * 600 * 4 / dt / 1e6:.4f} Mpaths/s on {smi}; launches {ln}; "
              f"film mean {comp.mean():.5f}")
        if not (ln["isect_brute"] > 0 and np.isfinite(comp).all() and comp.mean() > 0):
            raise AssertionError(f"config T {integ}: launches {ln}, film mean {comp.mean()}")
    cfg_ad = dataclasses.replace(cfg_a, integrator="direct_mis")
    out, dt, ln = scan_render(scene_a, cfg_ad, 1)
    comp = out["composite"]
    slice_runs["config_a_direct_mis"] = {"s": dt, "mpaths_s": 800 * 600 / dt / 1e6,
                                         "launches": ln, "film_mean": float(comp.mean())}
    print(f"  config A 800x600 direct_mis, 1 spp: {dt:.4f} s, {800 * 600 / dt / 1e6:.4f} "
          f"Mpaths/s on {smi}; launches {ln}; film mean {comp.mean():.5f}")
    if not (ln["isect_bvh_closest"] > 0 and ln["isect_bvh_any"] > 0 and ln["isect_brute"] == 0
            and np.isfinite(comp).all() and comp.mean() > 0):
        raise AssertionError(f"config A direct_mis: launches {ln}")
    prof_dm = device_breakdown(lambda: render(
        scene_c, dataclasses.replace(cfg_c, integrator="direct_mis"), sample_count=1,
        device=dev))
    print(f"  Cornell 800x600 direct_mis, 1 spp under the profiler: {json.dumps(prof_dm)}")
    phase(15, "the eight single-bounce integrators, config T and config A direct_mis rendered "
              "through the scan path: " + ", ".join(
                  f"{k} {v['mpaths_s']:.3f}" for k, v in slice_runs.items()) + " Mpaths/s")

    # ---- 16. the slice against the goldens, and config T on the card against the CPU
    for integ in ("direct_mis", "normals"):
        hold_golden(integ, dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        scene_t, cfg_t, _ = load_scene(textured_cornell_xml(Path(tmp), 64, 48, 4, rfilter="box"),
                                       dev)
    for integ in ("direct_mis", "path_mis"):
        cfg = dataclasses.replace(cfg_t, integrator=integ)
        a = render(scene_t, cfg, device=dev)["composite"]
        b = render(scene_t, cfg, device="cpu")["composite"]
        rel = np.abs(a - b) / (np.abs(b) + 1e-3)
        st = {"median_rel_err": float(np.median(rel)), "max_abs_err": float(np.abs(a - b).max()),
              "mean_cuda": float(a.mean()), "mean_cpu": float(b.mean())}
        print(f"  config T 64x48 box {integ}, cuda against cpu: {json.dumps(st)}")
        if not (st["median_rel_err"] < 1e-4
                and abs(st["mean_cuda"] - st["mean_cpu"]) <= 1e-3 * abs(st["mean_cpu"])):
            raise AssertionError(f"config T {integ}: the card's film differs from the CPU's: {st}")
    phase(16, "the scan path reproduces cbox_direct_mis / cbox_normals, and config T on cuda "
              "matches the CPU")

    # ---- 17. the tracking kernel against its plain version
    from optix_renderer_tpu_torch.ops import volume_grid as vg
    from optix_renderer_tpu_torch.ops.cuda import track
    from optix_renderer_tpu_torch.render import sampler as smp
    from optix_renderer_tpu_torch.scene.data import Media, corner_stack
    from optix_renderer_tpu_torch.scene.presets import medium_cornell_xml
    from optix_renderer_tpu_torch.tools.time_isect import pixel_rays

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        scene_h, cfg_h, _ = load_scene(medium_cornell_xml(Path(tmp), 800, 600, 1, "path_vol_mis",
                                                          "H"), dev)
        scene_v, cfg_v, _ = load_scene(medium_cornell_xml(Path(tmp), 800, 600, 1, "path_vol_mis",
                                                          "V"), dev)
    cfg_h, cfg_v = (dataclasses.replace(c, max_depth=8) for c in (cfg_h, cfg_v))
    media_h = scene_h.media.to(dev)
    stack_mb = (media_h.vol_corners.numel() + media_h.vol_tcorners.numel()) * 4 / 1e6
    het = int(torch.nonzero(scene_h.media.type == 2)[0, 0])
    n_h = cfg_h.width * cfg_h.height
    cam = pixel_rays(scene_h, cfg_h, 1, rng, dev)
    med_h = torch.full((n_h,), het, dtype=torch.int32, device=dev)
    state0 = smp.make_sampler(torch.arange(n_h, device=dev), 0).state
    inf_h = torch.full((n_h,), float("inf"), device=dev)

    def hold_tracker(what, ratio, o, d, dist):
        """The kernel against the plain lockstep loop on the same inputs:
        out, K and the state words equal (torch.equal)."""
        got = track.track(ratio, media_h, med_h, state0, o, d, dist)
        plain = vg.ratio_track_ref if ratio else vg.delta_track_ref
        plain_call = lambda: plain(media_h, med_h, smp.Sampler(state0), o, d, dist)
        plain_call()  # warm-up: the first call also loads torch's kernels
        ref, plain_ms = timed(plain_call)
        torch.cuda.synchronize()
        same = [torch.equal(got[0], ref[1]), torch.equal(got[1], ref[2])] + [
            torch.equal(a, b) for a, b in zip(got[2], ref[0].state)]
        fin = torch.isfinite(ref[1])
        err = float((got[0] - ref[1])[fin].abs().max()) if bool(fin.any()) else 0.0
        k_sum, n_iter = int(got[1].sum()), int(got[3].item())
        print(f"  {what}: {o.shape[0]} lanes, active {float((got[1] > 0).float().mean()):.4f}, "
              f"sum K {k_sum}, mean K over active lanes "
              f"{k_sum / max(int((got[1] > 0).sum()), 1):.3f}, L {n_iter}; out / K / state "
              f"words equal to the plain version: {same}; plain {plain_ms:.3f} ms", flush=True)
        if not all(same):
            raise AssertionError(f"{what}: the kernel differs from its plain version: {same}")
        call = lambda: track.track(ratio, media_h, med_h, state0, o, d, dist)
        alone = profiled_ms(call, 7, "walk_kernel") + profiled_ms(call, 7, "advance_kernel")
        spin = float(np.median(spin_ms(call, 7)))
        bnd = bound(k_sum * OPS_STEP + o.shape[0] * OPS_LANE, k_sum * 32 + o.shape[0] * LANE_BYTES)
        print(f"  {what}: kernel alone {alone:.4f} ms (torch.profiler, walk + advance), behind a "
              f"spin {spin:.4f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.5f} ms ({bnd[1]}) "
              f"on {smi}", flush=True)
        return {"err": err, "ms": alone, "ms_behind_spin": spin, "plain_ms": plain_ms,
                "bound": bnd, "sum_k": k_sum, "L": n_iter, "lanes": o.shape[0]}

    delta_row = hold_tracker("delta_track, config H camera rays", False, cam.o, cam.d, inf_h)
    t_ev = track.track(False, media_h, med_h, state0, cam.o, cam.d, inf_h)[0]
    # shadow rays: from each collision point (else a point of the box)
    # toward a random point of the ceiling light
    u = torch.from_numpy(rng.uniform(size=(n_h, 6)).astype(np.float32)).to(dev)
    lo, hi = media_h.vol_bbox_min[0], media_h.vol_bbox_max[0]
    hit = torch.isfinite(t_ev)[:, None]
    o_s = torch.where(hit, cam.o + cam.d * torch.where(hit[:, 0], t_ev, 0.0)[:, None],
                      lo + (hi - lo) * u[:, :3])
    light = torch.stack([-0.4 + 0.8 * u[:, 3], torch.full_like(u[:, 4], 1.99),
                         -0.4 + 0.8 * u[:, 5]], dim=-1)
    to_l = light - o_s
    dist_s = to_l.norm(dim=-1)
    ratio_row = hold_tracker("ratio_track, shadow rays toward the light", True, o_s,
                             to_l / dist_s[:, None], dist_s)
    track_regs = {k: v for k, v in ptxas_report(info.get("ptxas", "")).items()
                  if re.search(r"walk_kernel|advance_kernel", k)}
    print(f"  tracking kernels (ptxas): {track_regs}; corner stacks {stack_mb:.1f} MB")
    if len(track_regs) != 3:
        raise AssertionError(f"ptxas reported {len(track_regs)} tracking kernels, not 3")
    # a constant-density 16^3 grid on the unit cube, sigma_t 4: escape
    # probability over depth 1 and mean T over 0.6, against exp(-sigma_t d)
    # (the trilinear ramp at a face takes 1/128 off the depth)
    one = lambda v, dt=torch.float32: torch.tensor(v, dtype=dt, device=dev)
    grid = torch.from_numpy(corner_stack(np.ones((1, 16, 16, 16), np.float32))).to(dev)
    const = Media(type=one([2], torch.int32), sigma_a=one([[2.0] * 3]), sigma_s=one([[2.0] * 3]),
                  phase_type=one([0], torch.int32), phase_g=one([0.0]),
                  emitter=one([-1], torch.int32), vol_id=one([0], torch.int32),
                  density_scale=one([1.0]), temperature_scale=one([0.0]),
                  vol_dims=one([[16] * 3], torch.int32), vol_bbox_min=one([[-0.5] * 3]),
                  vol_bbox_max=one([[0.5] * 3]), vol_majorant=one([1.0]), vol_corners=grid,
                  vol_tcorners=grid, grid=(16, 16, 16))
    n_c = 1 << 16
    o_c = one([0.0, -0.5, 0.0]).expand(n_c, 3).contiguous()
    d_c = one([0.0, 1.0, 0.0]).expand(n_c, 3).contiguous()
    med_c = torch.zeros(n_c, dtype=torch.int32, device=dev)
    st_c = smp.make_sampler(torch.arange(n_c, device=dev), 1).state
    esc = float(torch.isinf(track.track(False, const, med_c, st_c, o_c, d_c,
                                        torch.ones(n_c, device=dev))[0]).float().mean())
    tr_c = track.track(True, const, med_c, st_c, o_c, d_c, torch.full((n_c,), 0.6, device=dev))[0]
    want_esc, want_tr = np.exp(-4.0 * (1 - 1 / 64)), np.exp(-4.0 * (0.6 - 1 / 128))
    print(f"  constant grid, sigma_t 4: escape {esc:.5f} (analytic {want_esc:.5f}), mean T "
          f"{float(tr_c.mean()):.5f} (analytic {want_tr:.5f})")
    if not (abs(esc - want_esc) < 0.005 and abs(float(tr_c.mean()) - want_tr) < 0.02 * want_tr):
        raise AssertionError("the tracking kernel misses the constant grid's analytic statistics")
    phase(17, "the tracking kernel equals its plain version bit for bit (delta on config H's "
              "camera rays, ratio on shadow rays) and meets the constant grid's statistics")

    # ---- 18. configs H and V through render(), with exact launch counts
    def media_render(scene, cfg):
        """(film, s, launches) of one timed 1-spp `render()` after a 1-spp
        warm-up, the counts set to 0 just before it and read just after."""
        render(scene, cfg, sample_count=1, device=dev)
        tracing.reset_counters("launch.")
        torch.cuda.synchronize()
        t0 = time.time()
        out = render(scene, cfg, sample_count=1, device=dev)  # returns host numpy
        return out, time.time() - t0, launches_of(KERNELS)

    D = cfg_h.max_depth
    media_runs = {}
    for name, scene, cfg in (("config_h_path_vol_mis", scene_h, cfg_h),
                             ("config_h_path_vol_mats",
                              scene_h, dataclasses.replace(cfg_h, integrator="path_vol_mats")),
                             ("config_v_path_vol_mis", scene_v, cfg_v)):
        mis = cfg.integrator == "path_vol_mis"
        heterog = name.startswith("config_h")
        want = {**{k: 0 for k in KERNELS},
                "isect_brute": D * (9 if mis else 1),
                "delta_track": D if heterog else 0, "ratio_track": 8 * D if heterog and mis else 0}
        if pathk.pathk_eligible(scene, cfg):
            raise AssertionError(f"{name}: the path kernel took a media scene")
        out, dt, ln = media_render(scene, cfg)
        comp = out["composite"]
        media_runs[name] = {"s": dt, "mpaths_s": n_h / dt / 1e6, "launches": ln,
                            "film_mean": float(comp.mean())}
        print(f"  {name} {cfg.width}x{cfg.height} depth {D}, 1 spp: {dt:.4f} s, "
              f"{n_h / dt / 1e6:.4f} Mpaths/s on {smi}; launches {ln}; film mean "
              f"{comp.mean():.5f}", flush=True)
        if ln != want:
            raise AssertionError(f"{name}: launches {ln}, expected {want}")
        if not (np.isfinite(comp).all() and comp.shape == (cfg.height, cfg.width, 3)
                and comp.mean() > 0):
            raise AssertionError(f"{name}: the film is not finite / positive")
    prof_h = device_breakdown(lambda: render(scene_h, cfg_h, sample_count=1, device=dev), top=10,
                              sums=("walk_kernel", "advance_kernel", "brute_kernel"))
    print(f"  config H 800x600 path_vol_mis, 1 spp under the profiler: {json.dumps(prof_h)}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        xml = medium_cornell_xml(Path(tmp), 160, 120, 1, "path_vol_mis", "H")
        subprocess.run([sys.executable, "-m", "optix_renderer_tpu_torch", "render", str(xml),
                        "--device", "cuda", "--depth", "8", "--size", "160x120"], cwd=ROOT,
                       check=True, timeout=600)
        img = read_exr(xml.with_suffix(".exr"))
        if not (xml.with_suffix(".png").stat().st_size > 0 and img.shape == (120, 160, 3)
                and np.isfinite(img).all() and img.mean() > 0):
            raise AssertionError("CLI output of config H is missing or malformed")
    phase(18, "configs H and V rendered through render() with the exact launch counts, and "
              "config H through the CLI: " + ", ".join(
                  f"{k} {v['mpaths_s']:.3f}" for k, v in media_runs.items()) + " Mpaths/s")

    # ---- 19. configs H and V on the card against the CPU
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        small = {k: load_scene(medium_cornell_xml(Path(tmp), 64, 48, 4, "path_vol_mis", k,
                                                  rfilter="box"), dev)[:2] for k in "HV"}
    for kind, (scene, cfg) in small.items():
        cfg = dataclasses.replace(cfg, max_depth=8)
        a = render(scene, cfg, device=dev)["composite"]
        b = render(scene, cfg, device="cpu")["composite"]
        rel = np.abs(a - b) / (np.abs(b) + 1e-3)
        st = {"median_rel_err": float(np.median(rel)), "max_abs_err": float(np.abs(a - b).max()),
              "pixels_over_1e-3": int((rel.max(axis=-1) > 1e-3).sum()),
              "mean_cuda": float(a.mean()), "mean_cpu": float(b.mean())}
        print(f"  config {kind} 64x48 box path_vol_mis, 4 spp, cuda against cpu: {json.dumps(st)}")
        if not (st["median_rel_err"] < 1e-3
                and abs(st["mean_cuda"] - st["mean_cpu"]) <= 0.1 * abs(st["mean_cpu"])):
            raise AssertionError(f"config {kind}: the card's film differs from the CPU's: {st}")
    phase(19, "configs H and V on cuda match the CPU by the median statistic")

    # ---- 20. the train step at full width: Cornell, path_mis, depth 16, 1 spp
    from optix_renderer_tpu_torch.parallel.shard import apply_params, train_step, trainable_params
    from optix_renderer_tpu_torch.render import film as film_ops
    from optix_renderer_tpu_torch.render.render import render_round
    from optix_renderer_tpu_torch.scene.data import BsdfType

    def reset_counts():
        tracing.reset_counters("launch.")

    def read_counts():
        return launches_of(KERNELS)

    def synced(fn):
        """(fn(), its seconds with the device synchronized on both sides)."""
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t0

    def with_params(scene, em=None, sigma_s=None):
        """The scene with emitter radiance and / or the media's sigma_s replaced."""
        if em is not None:
            scene = dataclasses.replace(scene, emitters=dataclasses.replace(scene.emitters,
                                                                            radiance=em))
        if sigma_s is not None:
            scene = dataclasses.replace(scene, media=dataclasses.replace(scene.media,
                                                                         sigma_s=sigma_s))
        return scene

    def directional(grads, seed):
        """sum of grads . a seeded random direction per key (on the CPU)."""
        r = np.random.default_rng(seed)
        return sum(float((g.cpu() * torch.from_numpy(
            r.standard_normal(tuple(g.shape)).astype(np.float32))).sum())
            for _, g in sorted(grads.items()))

    scene_g, cfg_g, _ = make_cornell_box(800, 600, 1, "path_mis", device=dev)
    cfg_g = dataclasses.replace(cfg_g, max_depth=16)
    n_g = cfg_g.width * cfg_g.height
    ids_g = torch.arange(n_g, device=dev)
    em0 = scene_g.emitters.radiance
    with torch.no_grad():  # the target: the same scene, the same samples, radiance x 0.8
        target_g = film_ops.to_bitmap(render_round(with_params(scene_g, em=em0 * 0.8), cfg_g,
                                                   ids_g, 0))[0]

    def mse(scene):
        return torch.mean((film_ops.to_bitmap(render_round(scene, cfg_g, ids_g, 0))[0]
                           - target_g) ** 2)

    # the step split: forward, then backward, each counted and timed (the
    # first backward in the process also loads its kernels)
    leaves = {k: v.detach().requires_grad_(True) for k, v in trainable_params(scene_g).items()}
    reset_counts()
    loss_split, fwd_s = synced(lambda: mse(apply_params(scene_g, leaves)))
    fwd_counts = read_counts()
    _, bwd_s = synced(lambda: torch.autograd.grad(loss_split, list(leaves.values()),
                                                  allow_unused=True))
    bwd_counts = read_counts()
    # the entry point, counted and timed (its forward and backward together)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    (loss_g, grads_g), step_s = synced(lambda: train_step(scene_g, cfg_g, target_g, ids_g, 0,
                                                          device=dev))
    step_counts, step_peak = read_counts(), torch.cuda.max_memory_allocated(dev)
    with torch.no_grad():
        _, nograd_s = synced(lambda: mse(scene_g))
    want_g = {k: 0 for k in fwd_counts}
    want_g["isect_brute"] = 2 * cfg_g.max_depth  # a closest hit and a shadow ray per bounce
    norms_g = {k: float(v.norm()) for k, v in grads_g.items()}
    train_row = {"loss": float(loss_g), "grad_norms": norms_g, "step_s": step_s,
                 "forward_s": fwd_s, "backward_s": bwd_s, "forward_no_graph_s": nograd_s,
                 "peak_gb": step_peak / 1e9, "launches": step_counts,
                 "forward_launches": fwd_counts, "backward_launches": {
                     k: bwd_counts[k] - fwd_counts[k] for k in fwd_counts}}
    print(f"  train step, Cornell 800x600 path_mis depth 16, 1 spp, on {smi}: "
          f"{json.dumps(train_row)}", flush=True)
    if fwd_counts != want_g or step_counts != want_g or bwd_counts != fwd_counts:
        raise AssertionError(f"train step launches: step {step_counts}, forward {fwd_counts}, "
                             f"after the backward {bwd_counts}; expected {want_g}")
    if not (all(bool(torch.isfinite(g).all()) for g in grads_g.values())
            and norms_g["em_radiance"] > 0 and bool(torch.isfinite(loss_g))):
        raise AssertionError(f"train step: loss {float(loss_g)}, gradient norms {norms_g}")
    loss_split = float(loss_split.detach())
    if not abs(loss_split - float(loss_g)) <= 1e-5 * float(loss_g):
        raise AssertionError(f"the split step's loss {loss_split} is not the step's "
                             f"{float(loss_g)}")
    # FD against AD along one random direction of em_radiance
    d_em = torch.from_numpy(np.random.default_rng(20).standard_normal(tuple(em0.shape))
                            .astype(np.float32)).to(dev)
    h_fd = 2e-2
    with torch.no_grad():
        fd_g = (float(mse(with_params(scene_g, em=em0 + h_fd * d_em)))
                - float(mse(with_params(scene_g, em=em0 - h_fd * d_em)))) / (2 * h_fd)
    ad_g = float((grads_g["em_radiance"] * d_em).sum())
    print(f"  em_radiance direction: AD {ad_g:.7e}, FD {fd_g:.7e} (h {h_fd}), rel "
          f"{abs(ad_g - fd_g) / abs(fd_g):.3e}")
    if not (abs(ad_g) > 0 and abs(ad_g - fd_g) <= 2e-2 * abs(fd_g)):
        raise AssertionError(f"train step: AD {ad_g} against FD {fd_g}")
    # three SGD steps on em_radiance toward the target (taken here, not by the package)
    em, sgd_losses, g_em = em0, [float(loss_g)], grads_g["em_radiance"]
    for step in range(3):
        em = em - 30.0 * g_em
        if step < 2:
            loss_s, grads_s = train_step(with_params(scene_g, em=em), cfg_g, target_g, ids_g, 0,
                                         device=dev)
            sgd_losses.append(float(loss_s))
            g_em = grads_s["em_radiance"]
        else:
            with torch.no_grad():
                sgd_losses.append(float(mse(with_params(scene_g, em=em))))
    train_row["sgd_losses"] = sgd_losses
    print(f"  3 SGD steps on em_radiance (lr 30): losses {sgd_losses}; radiance "
          f"{em.flatten().tolist()} (the target's {(em0 * 0.8).flatten().tolist()})")
    if not all(b < a for a, b in zip(sgd_losses, sgd_losses[1:])):
        raise AssertionError(f"the loss did not fall: {sgd_losses}")
    # the card against the CPU at 64x48, depth 3: each train_step key's
    # directional derivative, on the box with its odd diffuse BSDF rows made
    # microfacet (ks 0.3, alpha 0.3), so that bsdf_kd and bsdf_alpha reach the
    # loss beside tex_value and em_radiance (on the diffuse box their
    # gradients are 0)
    scene_s, cfg_s, _ = make_cornell_box(64, 48, 1, "path_mis", device=dev)
    cfg_s = dataclasses.replace(cfg_s, max_depth=3)
    b_s = scene_s.bsdfs
    odd = (torch.arange(b_s.type.shape[0], device=dev) % 2 == 1) & (b_s.type == BsdfType.DIFFUSE)
    scene_s = dataclasses.replace(scene_s, bsdfs=dataclasses.replace(
        b_s, type=torch.where(odd, BsdfType.MICROFACET, b_s.type).to(b_s.type.dtype),
        ks=torch.where(odd, 0.3, b_s.ks), alpha=torch.where(odd, 0.3, b_s.alpha)))
    target_s = torch.from_numpy(np.random.default_rng(22).uniform(0, 1, (48, 64, 3))
                                .astype(np.float32))
    dirs_s = {}
    for d in (dev, torch.device("cpu")):
        _, g_s = train_step(scene_s, cfg_s, target_s, torch.arange(64 * 48), 0, device=d)
        dirs_s[d.type] = {k: directional({k: v}, 20) for k, v in g_s.items()}
    rel_s = {k: abs(dirs_s["cuda"][k] - v) / abs(v) if v else float("inf")
             for k, v in dirs_s["cpu"].items()}
    train_row["directional_64x48_depth3"] = {**dirs_s, "rel_err": rel_s}
    print(f"  train_step directional derivatives at 64x48, depth 3, cuda against cpu: "
          f"{json.dumps(train_row['directional_64x48_depth3'])}")
    if set(rel_s) != {"tex_value", "bsdf_kd", "bsdf_alpha", "em_radiance"} or not all(
            r <= 1e-3 for r in rel_s.values()):
        raise AssertionError(f"train_step on cuda against the cpu: {dirs_s}")
    # why parameter tables are gathered by core/math.rows: the backward of a
    # gather of 480,000 lanes from an 8-row table, by advanced indexing (its
    # backward sorts the indices) and by rows (index_select; index_add_)
    from optix_renderer_tpu_torch.core.math import rows

    tbl = torch.rand((8, 3), device=dev, requires_grad=True)
    lane_rows = torch.randint(0, 8, (n_g,), device=dev)
    ones = torch.ones((n_g, 3), device=dev)
    gather_ms = {name: event_ms(lambda f=f: torch.autograd.grad(f(), tbl, ones), reps=10)
                 for name, f in (("advanced_indexing", lambda: tbl[lane_rows]),
                                 ("rows_index_select", lambda: rows(tbl, lane_rows)))}
    train_row["gather_backward_ms"] = gather_ms
    print(f"  gather + backward of {n_g} lanes from an 8-row table, ms: {json.dumps(gather_ms)}")
    prof_g = device_breakdown(lambda: train_step(scene_g, cfg_g, target_g, ids_g, 0,
                                                 device=dev), top=8,
                              sums=("indexing_backward", "indexFunc", "brute_kernel"))
    train_row["profile"] = prof_g
    print(f"  one train step under the profiler: {json.dumps(prof_g)}")
    phase(20, f"train step at 800x600 depth 16: {step_s:.3f} s (forward {fwd_s:.3f}, backward "
              f"{bwd_s:.3f}), peak {step_peak / 1e9:.2f} GB, {fwd_counts['isect_brute']} "
              "isect_brute launches in the forward, none in the backward")

    # ---- 21. gradients through the LBVH walk and through the trackers
    def grad_run(scene, cfg, dev_):
        """mean(to_bitmap(render_round)[0]^2) of one 1-spp round and its
        gradients with respect to em_radiance and, with voxel grids, the
        media's sigma_s, forward and backward apart: (loss, grads, forward
        s, backward s, forward launches, backward launches, peak bytes)."""
        scene = scene.to(dev_)
        leaves = {"em_radiance": scene.emitters.radiance.detach().requires_grad_(True)}
        if vg.has_volumes(scene.media):
            leaves["sigma_s"] = scene.media.sigma_s.detach().requires_grad_(True)
        sc = with_params(scene, em=leaves["em_radiance"], sigma_s=leaves.get("sigma_s"))
        ids = torch.arange(cfg.width * cfg.height, device=dev_)
        cuda = dev_.type == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev_)
        reset_counts()
        sync()
        t0 = time.time()
        loss = torch.mean(film_ops.to_bitmap(render_round(sc, cfg, ids, 0))[0] ** 2)
        sync()
        t1, c_fwd = time.time(), read_counts()
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        sync()
        c_bwd = {k: v - c_fwd[k] for k, v in read_counts().items()}
        return (loss.detach(), grads, t1 - t0, time.time() - t1, c_fwd, c_bwd,
                torch.cuda.max_memory_allocated(dev_) if cuda else 0)

    scene_l, cfg_l, _ = make_tessellated_cornell(800, 600, 1, "path_mis", nu=12, nv=7, device=dev)
    cfg_l = dataclasses.replace(cfg_l, max_depth=3)
    if scene_l.geometry.tri_v0.shape[0] != 300 or scene_l.geometry.bvh is None:
        raise AssertionError("the LBVH gradient scene is not the 300-triangle box")
    grad_rows = {}
    for name, scene, cfg, want in (
            ("lbvh_300_path_mis_depth3", scene_l, cfg_l,
             {"isect_bvh_closest": cfg_l.max_depth, "isect_bvh_any": cfg_l.max_depth}),
            ("config_h_path_vol_mis_depth8", scene_h, cfg_h,
             {"isect_brute": 9 * cfg_h.max_depth, "delta_track": cfg_h.max_depth,
              "ratio_track": 8 * cfg_h.max_depth})):
        want = {**{k: 0 for k in read_counts()}, **want}
        loss, grads, f_s, b_s, c_f, c_b, peak = grad_run(scene, cfg, dev)
        row_g = {"loss": float(loss), "grad_norms": {k: float(g.norm()) for k, g in grads.items()},
                 "forward_s": f_s, "backward_s": b_s, "peak_gb": peak / 1e9,
                 "forward_launches": c_f, "backward_launches": c_b}
        small = dataclasses.replace(cfg, width=64, height=48, max_depth=3)
        dirs = {d.type: directional(grad_run(scene, small, d)[1], 21)
                for d in (dev, torch.device("cpu"))}
        row_g["directional_64x48_depth3"] = dirs
        row_g["directional_rel_err"] = abs(dirs["cuda"] - dirs["cpu"]) / abs(dirs["cpu"])
        grad_rows[name] = row_g
        print(f"  {name} 800x600, 1 spp, on {smi}: {json.dumps(row_g)}", flush=True)
        if c_f != want or any(c_b.values()):
            raise AssertionError(f"{name}: forward launches {c_f} (expected {want}), backward "
                                 f"{c_b}")
        if not all(bool(torch.isfinite(g).all()) for g in grads.values()):
            raise AssertionError(f"{name}: a gradient is not finite")
        if not (abs(dirs["cpu"]) > 0 and row_g["directional_rel_err"] <= 1e-3):
            raise AssertionError(f"{name}: directional derivative on cuda {dirs['cuda']}, on the "
                                 f"cpu {dirs['cpu']}")
    phase(21, "gradients through isect_bvh (closest, any) and the tracking kernel at 800x600: "
              "the forward launches each, the backward none; 64x48 directional derivatives on "
              "cuda match the cpu")

    # ---- 22. the adaptive render at full width, through render_adaptive and the CLI
    from optix_renderer_tpu_torch.render.adaptive import render_adaptive

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        xml = cornell_box_xml(tmp, 800, 600, 16, "path_mis", sampler="adaptive")
        scene_ad, cfg_ad, _ = load_scene(xml, dev)
        if not (cfg_ad.adaptive and cfg_ad.adaptive_uniform_rounds == 4) or \
                pathk.pathk_eligible(scene_ad, cfg_ad):
            raise AssertionError("the adaptive Cornell box did not build as an adaptive config "
                                 "off the path kernel")
        n_ad = cfg_ad.width * cfg_ad.height
        render_adaptive(scene_ad, cfg_ad, sample_count=1, device=dev)  # warm-up
        reset_counts()
        out_ad, ad_s = synced(lambda: render_adaptive(scene_ad, cfg_ad, device=dev))
        ad_counts = read_counts()
        rounds = out_ad["samples_placed"] // n_ad
        ad_row = {"samples_placed": out_ad["samples_placed"], "rounds": rounds, "s": ad_s,
                  "mpaths_s": out_ad["samples_placed"] / ad_s / 1e6, "launches": ad_counts,
                  "film_mean": float(out_ad["composite"].mean())}
        print(f"  adaptive Cornell 800x600 path_mis depth {cfg_ad.max_depth}, 16 spp, 4 uniform "
              f"rounds, on {smi}: {json.dumps(ad_row)}", flush=True)
        want_ad = {**{k: 0 for k in ad_counts}, "isect_brute": 2 * cfg_ad.max_depth * rounds}
        if ad_counts != want_ad or not 4 <= rounds <= 16:
            raise AssertionError(f"adaptive render: {rounds} rounds, launches {ad_counts}, "
                                 f"expected {want_ad}")
        if not (np.isfinite(out_ad["composite"]).all() and out_ad["composite"].mean() > 0
                and out_ad["variance"].shape == (600, 800)):
            raise AssertionError("the adaptive film is not finite / positive")
        cli_out = Path(tmp) / "adaptive"
        subprocess.run([sys.executable, "-m", "optix_renderer_tpu_torch", "render", str(xml),
                        "--device", "cuda", "-o", str(cli_out)], cwd=ROOT, check=True,
                       timeout=600)
        var_img = read_exr(str(cli_out) + "_variance.exr")
        img = read_exr(cli_out.with_suffix(".exr"))
        if not (cli_out.with_suffix(".png").stat().st_size > 0 and img.shape == (600, 800, 3)
                and np.isfinite(img).all() and var_img.shape == (600, 800, 3)
                and np.isfinite(var_img).all() and var_img.max() > 0):
            raise AssertionError("the CLI's adaptive outputs are missing or malformed")
    # 64x48 on the card against the CPU: the same samples placed, the films
    # by phase 16's median statistic
    small_ad = dataclasses.replace(cfg_ad, width=64, height=48)
    a_ad = render_adaptive(scene_ad, small_ad, device=dev)
    b_ad = render_adaptive(scene_ad, small_ad, device="cpu")
    rel = np.abs(a_ad["composite"] - b_ad["composite"]) / (np.abs(b_ad["composite"]) + 1e-3)
    st_ad = {"samples_cuda": a_ad["samples_placed"], "samples_cpu": b_ad["samples_placed"],
             "median_rel_err": float(np.median(rel)),
             "max_abs_err": float(np.abs(a_ad["composite"] - b_ad["composite"]).max()),
             "mean_cuda": float(a_ad["composite"].mean()),
             "mean_cpu": float(b_ad["composite"].mean())}
    ad_row["small_cuda_against_cpu"] = st_ad
    print(f"  adaptive 64x48, 16 spp, cuda against cpu: {json.dumps(st_ad)}")
    if not (st_ad["samples_cuda"] == st_ad["samples_cpu"] and st_ad["median_rel_err"] < 1e-4
            and abs(st_ad["mean_cuda"] - st_ad["mean_cpu"]) <= 1e-3 * abs(st_ad["mean_cpu"])):
        raise AssertionError(f"adaptive 64x48: the card differs from the CPU: {st_ad}")
    phase(22, f"adaptive render at 800x600: {out_ad['samples_placed']} samples in {rounds} "
              f"rounds, {ad_row['mpaths_s']:.3f} Mpaths/s; the CLI wrote EXR, PNG and "
              "_variance.exr; 64x48 on cuda matches the cpu")

    # ---- 23. the photon mapper at full width: cornell_pmap_800x600
    from optix_renderer_tpu_torch.denoise import learned
    from optix_renderer_tpu_torch.denoise.bilateral import denoise_bilateral
    from optix_renderer_tpu_torch.integrators import common
    from optix_renderer_tpu_torch.ops import photon as photon_ops
    from optix_renderer_tpu_torch.render.render import preprocess
    from optix_renderer_tpu_torch.render.variance import variance_from_image

    scene_p, cfg_p, _ = make_cornell_box(800, 600, 4, "photonmapper", device=dev)
    # photonRadius 0: the radius the build derives itself (bbox diagonal / 500)
    cfg_p = dataclasses.replace(cfg_p, max_depth=16, rfilter="gaussian",
                                iprops=(("photonCount", 1_000_000), ("photonRadius", 0.0)))
    if pathk.pathk_eligible(scene_p, cfg_p):
        raise AssertionError("the path kernel took the photon mapper")
    n_p = cfg_p.width * cfg_p.height
    render(scene_p, cfg_p, sample_count=1, device=dev)  # warm-up: builds its own map
    # the build alone: one `isect_brute` launch per bounce of each photon batch
    reset_counts()
    scene_pm, build_s = synced(lambda: preprocess(scene_p, cfg_p, dev))
    build_counts = read_counts()
    pm = scene_pm.photons
    batch = max(1_000_000 // 2, 1024)
    emitted = int(round(1.0 / float(pm.inv_emitted)))
    rounds = emitted // batch
    if emitted != rounds * batch or build_counts["isect_brute"] != 16 * rounds:
        raise AssertionError(f"photon build: {emitted} emitted, launches {build_counts}")
    # the timed render builds its map again inside the clock (as every render() call does)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    out_p, render_s = synced(lambda: render(scene_p, cfg_p, device=dev))
    pmap_counts = read_counts()
    pmap_peak = torch.cuda.max_memory_allocated(dev)
    want_p = {**{k: 0 for k in pmap_counts}, "isect_brute": 16 * (rounds + 4)}
    if pmap_counts != want_p:
        raise AssertionError(f"photon-mapper render: launches {pmap_counts}, expected {want_p}")
    # the same render on the map built above: the render without its build
    reset_counts()
    out_p2, render_nb_s = synced(lambda: render(scene_pm, cfg_p, device=dev))
    if read_counts()["isect_brute"] != 64:
        raise AssertionError(f"render on a built map: launches {read_counts()}")
    comp_p = out_p["composite"]
    if not (np.isfinite(comp_p).all() and comp_p.shape == (600, 800, 3) and comp_p.mean() > 0):
        raise AssertionError("the photon-mapper film is not finite / positive")
    # photons found per gathering lane on the first bounce of one sample of
    # camera rays: candidates in the 27 cells' ranges, and those within r
    with torch.no_grad():
        ray0 = pixel_rays(scene_pm, cfg_p, 1, np.random.default_rng(23), dev)
        ctx0 = common.trace(scene_pm, ray0)
        p0 = ctx0.its.p[ctx0.its.valid & photon_ops.is_diffuse(scene_pm, ctx0.bsdf_id)]
        lo, hi = photon_ops.cell_ranges(pm, p0)
        found = torch.zeros(p0.shape[0], device=dev)
        r2 = pm.radius * pm.radius
        for k in range(photon_ops.MAX_PER_CELL):
            d = pm.pos[torch.clamp(lo + k, 0, pm.pos.shape[0] - 1)] - p0[:, None, :]
            found += (((lo + k) < hi) & ((d * d).sum(-1) < r2)).sum(1)
        candidates = float((hi - lo).sum(1).float().mean())
        full = float(((hi - lo) == photon_ops.MAX_PER_CELL).float().mean())
    # the gather's share of device time: one 1-spp render on the built map
    # under the profiler beside the same render with the estimate replaced
    # by zeros (the rest of the path does not read it); the gather's calls
    # and lanes counted
    estimate = photon_ops.estimate_radiance
    gather_calls = []

    def counted_estimate(pm_, sc, ctx, wo):
        gather_calls.append(wo.shape[0])
        return estimate(pm_, sc, ctx, wo)

    one = dataclasses.replace(cfg_p, sample_count=1)
    try:
        photon_ops.estimate_radiance = counted_estimate
        prof_p = device_breakdown(lambda: render(scene_pm, one, device=dev), top=4)
        photon_ops.estimate_radiance = lambda pm_, sc, ctx, wo: torch.zeros_like(wo)
        prof_z = device_breakdown(lambda: render(scene_pm, one, device=dev), top=4)
    finally:
        photon_ops.estimate_radiance = estimate
    gather_s = prof_p["device_busy_s"] - prof_z["device_busy_s"]
    prof_p.update(without_gather={k: prof_z[k] for k in ("wall_s", "device_busy_s", "kernels",
                                                          "idle_share")},
                  gather_device_s=gather_s, gather_share=gather_s / prof_p["device_busy_s"],
                  gather_kernels=prof_p["kernels"] - prof_z["kernels"],
                  gather_calls=len(gather_calls), gather_lanes=gather_calls)
    pmap_row = {
        "mpaths_s": 4 * n_p / render_s / 1e6, "s": render_s, "build_s": build_s,
        "mpaths_s_without_build": 4 * n_p / render_nb_s / 1e6, "s_without_build": render_nb_s,
        "photon_rounds": rounds, "emitted": emitted, "stored": int(pm.pos.shape[0]),
        "radius": float(pm.radius), "table_size": pm.table_size,
        "gathering_lanes_bounce0": int(p0.shape[0]),
        "mean_found_per_gather": float(found.mean()), "mean_candidates_per_gather": candidates,
        "share_of_cells_capped": full, "launches": pmap_counts, "build_launches": build_counts,
        "peak_gb": pmap_peak / 1e9, "profile_1spp": prof_p, "film_mean": float(comp_p.mean())}
    print(f"  cornell_pmap_800x600 (photonmapper, depth 16, gaussian, 1,000,000 photons, "
          f"auto radius), 4 spp, on {smi}: {json.dumps(pmap_row)}", flush=True)
    phase(23, f"photon mapper at 800x600: {pmap_row['mpaths_s']:.4f} Mpaths/s with the photon "
              f"build ({build_s:.3f} s apart), {pmap_row['mpaths_s_without_build']:.4f} without; "
              f"isect_brute {pmap_counts['isect_brute']} = 16 x ({rounds} + 4); gather "
              f"{prof_p['gather_share']:.3f} of device time; peak {pmap_row['peak_gb']:.2f} GB")

    # ---- 24. the photon mapper on the card against the CPU
    pm_small = {}
    for name, (scene_s, cfg_s) in {
            "cornell_48x48": make_cornell_box(48, 48, 4, "photonmapper", device=dev)[:2],
            "lbvh_300_64x48": make_tessellated_cornell(64, 48, 4, "photonmapper", nu=12,
                                                       nv=7, device=dev)[:2]}.items():
        cfg_s = dataclasses.replace(cfg_s, max_depth=8,
                                    iprops=(("photonCount", 20000), ("photonRadius", 0.12)))
        kernel = "isect_bvh_closest" if name.startswith("lbvh") else "isect_brute"
        # the first photon batch's stored slots on each device, and the
        # batches of one build (one launch per bounce of each)
        stored = {}
        for d_ in (dev, "cpu"):
            with torch.no_grad():
                stored[str(d_)] = int(photon_ops.trace_photons(
                    scene_s.to(d_), 10000, cfg_s.max_depth, 1, 0)[3].sum())
        reset_counts()
        preprocess(scene_s, cfg_s, dev)
        rounds_s = read_counts()[kernel] // cfg_s.max_depth
        reset_counts()
        a = render(scene_s, cfg_s, device=dev)["composite"]
        ln = read_counts()
        b = render(scene_s, cfg_s, device="cpu")["composite"]
        rel = np.abs(a - b) / (np.abs(b) + 1e-3)
        st = {"stored_cuda": stored[str(dev)], "stored_cpu": stored["cpu"], "rounds": rounds_s,
              "median_rel_err": float(np.median(rel)), "max_abs_err": float(np.abs(a - b).max()),
              "mean_cuda": float(a.mean()), "mean_cpu": float(b.mean()), "launches": ln}
        pm_small[name] = st
        print(f"  photon mapper {name}, depth 8, 20,000 photons, radius 0.12, 4 spp, cuda "
              f"against cpu: {json.dumps(st)}", flush=True)
        want = {**{k: 0 for k in ln}, kernel: cfg_s.max_depth * (rounds_s + 4)}
        if ln != want:
            raise AssertionError(f"photon mapper {name}: launches {ln}, expected {want}")
        if not (abs(st["stored_cuda"] - st["stored_cpu"]) <= 1e-3 * st["stored_cpu"]
                and st["median_rel_err"] < 1e-3
                and abs(st["mean_cuda"] - st["mean_cpu"]) <= 0.1 * abs(st["mean_cpu"])):
            raise AssertionError(f"photon mapper {name}: the card differs from the CPU: {st}")
    phase(24, "the photon mapper on cuda matches the cpu (stored photons, median statistic) on "
              "the Cornell box (isect_brute) and the 300-triangle box (isect_bvh)")

    # ---- 25. the denoisers: bilateral and learned, the card against the CPU
    film_p = np.concatenate([comp_p, out_p["weights"][..., None]], axis=-1)
    bil = {}
    for d_ in (dev, "cpu"):
        f_ = torch.from_numpy(film_p).to(d_)
        bil[str(d_)] = denoise_bilateral(f_[..., :3], variance_from_image(f_)).cpu().numpy()
    bil_err = float((np.abs(bil[str(dev)] - bil["cpu"]) / (np.abs(bil["cpu"]) + 1e-6)).max())
    print(f"  bilateral on phase 23's film, cuda against cpu: max rel err {bil_err:.3e}")
    if not bil_err <= 1e-5:
        raise AssertionError(f"bilateral: the card differs from the CPU by {bil_err}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        ck = Path(tmp) / "denoiser.npz"
        t0 = time.time()
        train = subprocess.run(
            [sys.executable, "-m", "optix_renderer_tpu_torch", "train-denoiser", "--device",
             "cuda", "--size", "128", "--steps", "300", "--clean-spp", "256", "-o", str(ck)],
            cwd=ROOT, check=True, timeout=600, capture_output=True, text=True).stdout
        train_s = time.time() - t0
        m = re.search(r"loss ([0-9.]+) → ([0-9.]+); saved", train)
        if m is None or not ck.exists():
            raise AssertionError(f"train-denoiser wrote no checkpoint:\n{train}")
        loss0, loss1 = float(m.group(1)), float(m.group(2))
        print(f"  train-denoiser 128x96, 300 steps, 256 clean spp, cuda, on {smi}: "
              f"{train_s:.2f} s of command, loss {loss0} -> {loss1}", flush=True)
        if not loss1 < 0.5 * loss0:
            raise AssertionError(f"train-denoiser: loss {loss0} -> {loss1}, not halved")
        # the trained net at 800x600 on phase 23's layers, card against CPU in FP32
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            den, nets = {}, {}
            for d_ in (dev, "cpu"):
                params = learned.load_checkpoint(ck, d_)
                lay = [torch.from_numpy(out_p[k]).to(d_)
                       for k in ("composite", "albedo", "normal")]
                nets[str(d_)] = (params, lay)
                den[str(d_)] = learned.apply(params, *lay).cpu().numpy()
            params_c, lay_c = nets[str(dev)]
            ms_apply = event_ms(lambda: learned.apply(params_c, *lay_c), reps=5)
            # the same call with TF32 convolutions, the card's default
            torch.backends.cudnn.allow_tf32 = True
            den_tf32 = learned.apply(params_c, *lay_c).cpu().numpy()
            ms_tf32 = event_ms(lambda: learned.apply(params_c, *lay_c), reps=5)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        # out = expm1(y): the convolutions' rounding of y reaches out times
        # (1 + out), so the error is taken relative to 1 + |out|; the float64
        # result on the CPU says how far each FP32 one is from exact
        p64 = {k: v.double() for k, v in nets["cpu"][0].items()}
        exact = learned.apply(p64, *(t.double() for t in nets["cpu"][1])).numpy()

        def rel1(a_, b_):
            return float((np.abs(a_ - b_) / (1.0 + np.abs(b_))).max())

        den_err = rel1(den[str(dev)], den["cpu"])
        den_exact = {"cuda": rel1(den[str(dev)], exact), "cpu": rel1(den["cpu"], exact),
                     "cuda_tf32": rel1(den_tf32, exact)}
        # a checkpoint the port writes reloads to the same output
        ck2 = Path(tmp) / "again.npz"
        learned.save_checkpoint(ck2, learned.load_checkpoint(ck, dev))
        again = learned.apply(learned.load_checkpoint(ck2, dev), *lay_c)
        same = bool(torch.equal(again, learned.apply(learned.load_checkpoint(ck, dev), *lay_c)))
        print(f"  learned denoiser at 800x600, cuda (FP32 convolutions) against cpu: max "
              f"|a-b|/(1+|b|) {den_err:.3e} (against float64: cuda {den_exact['cuda']:.3e}, "
              f"cpu {den_exact['cpu']:.3e}, cuda with TF32 {den_exact['cuda_tf32']:.3e}); "
              f"{ms_apply:.3f} ms per call on the card ({ms_tf32:.3f} with TF32); checkpoint "
              f"round trip equal: {same}", flush=True)
        if not (den_err <= 1e-4 and same and np.isfinite(den[str(dev)]).all()):
            raise AssertionError(f"learned denoiser: err {den_err}, round trip {same}")
        xml = cornell_box_xml(tmp, 800, 600, 4, "photonmapper")
        base = Path(tmp) / "denoised"
        subprocess.run([sys.executable, "-m", "optix_renderer_tpu_torch", "render", str(xml),
                        "--device", "cuda", "--denoise", "learned", "--denoiser-ckpt", str(ck),
                        "-o", str(base)], cwd=ROOT, check=True, timeout=600)
        img = read_exr(str(base) + "_denoised.exr")
        if not ((Path(tmp) / "denoised_denoised.png").stat().st_size > 0
                and img.shape == (600, 800, 3) and np.isfinite(img).all()):
            raise AssertionError("the CLI's denoised outputs are missing or malformed")
    den_row = {"bilateral_max_rel_err": bil_err, "train_s": train_s, "loss_first": loss0,
               "loss_last": loss1, "learned_max_rel_err": den_err,
               "learned_err_against_float64": den_exact, "learned_apply_ms": ms_apply,
               "learned_apply_tf32_ms": ms_tf32}
    print(f"  denoisers on {smi}: {json.dumps(den_row)}")
    phase(25, f"denoisers: bilateral and learned on cuda match the cpu; train-denoiser "
              f"{train_s:.1f} s, loss {loss0} -> {loss1}; the CLI wrote _denoised.exr / .png")

    front = front_end(dev, smi, reset_counts, read_counts)
    fe_tests = front[26]["tests"]
    shard_rec = sharded(dev, smi, reset_counts, read_counts)
    mh_rec = multihost(dev, smi)
    sph = spheres(dev, smi, reset_counts, read_counts)
    wave = wavefront(dev, smi, reset_counts, read_counts)
    lb = lbvh(dev, smi, reset_counts, read_counts, launches_a)
    shd = scan_shading(dev, smi, scene_a, cfg_a, scene_b, cfg_b)
    shd_a = shd["config_a_path_mis"]
    spl = film_splat(dev, smi, scene_a, cfg_a, scene_b, cfg_b)
    spl_a = spl["config_a"]
    wave_launches = {k: v["launches"] for k, v in wave["bit_equal"].items()}
    wave_iters = {k: v["iterations"] for k, v in wave["bit_equal"].items()}
    kp = shard_rec["kernel_path"]

    def row(name, source, replaces, launches, err, ms, plain_ms, bnd, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None, **extra}

    print(json.dumps({"kernels": [
        row("pathk_trace", KERNEL_SOURCE, REPLACES, launches, stats["max_abs_err"], kernel_ms,
            plain_ms, (pathk_bound, pathk_by), median_rel_err=stats["median_rel_err"],
            kernel="pathk_kernel<MIS> (persistent blocks, lanes that refill)",
            shape="800x600 x 16 spp", iterations=iters, launch=main_launch,
            lane_efficiency=lane_eff, ptxas=small_regs,
            launches_sharded=kp["cornell_cuda0_x4"]["launches"],
            max_abs_err_sharded=kp["cornell_cuda0_x4"]["max_abs_err"],
            launches_sharded_all_cards=kp["cornell_all_cards"]["launches"],
            split_launch_equal=shard_rec["split_launch"]["small"]["equal"],
            mpaths_512=shard_rec["mpaths_512"]),
        row("isect_bvh_closest", ISECT_SOURCE, "optix_renderer_tpu/ops/pallas/cluster.py:454",
            launches_a["isect_bvh_closest"], err_bvh, ms_closest, plain_closest,
            bvh_rows["closest_camera"]["bound"], rays=MAIN_RAYS,
            launches_config_a_direct_mis=slice_runs["config_a_direct_mis"]["launches"][
                "isect_bvh_closest"],
            launches_gradient_lbvh_forward=grad_rows["lbvh_300_path_mis_depth3"][
                "forward_launches"]["isect_bvh_closest"],
            launches_photon_lbvh_64x48=pm_small["lbvh_300_64x48"]["launches"][
                "isect_bvh_closest"],
            launches_cli_test_furnace_bvh=fe_tests["furnace_bvh"]["launches"][
                "isect_bvh_closest"],
            max_abs_err_cli_test_furnace_bvh=front[26]["kernel_max_abs_err"]["furnace_bvh"],
            launches_wavefront_config_a=wave_launches["config_a_path_mis_1spp"][
                "isect_bvh_closest"],
            wavefront_iterations_config_a=wave_iters["config_a_path_mis_1spp"],
            kernel="bvh_kernel<false> (child-pair walk, persistent warps fed from a ray counter)",
            camera=bvh_rows["closest_camera"], bounce=bvh_rows["closest_bounce"],
            ms_bounce=bvh_rows["closest_bounce"]["ms"],
            bound_ms_bounce=bvh_rows["closest_bounce"]["bound"][0], ptxas=bvh_regs),
        row("isect_bvh_any", ISECT_SOURCE, "optix_renderer_tpu/ops/pallas/cluster.py:454",
            launches_a["isect_bvh_any"], err_any, ms_any, plain_any,
            bvh_rows["any_shadow"]["bound"], rays=MAIN_RAYS, kernel="bvh_kernel<true>",
            launches_gradient_lbvh_forward=grad_rows["lbvh_300_path_mis_depth3"][
                "forward_launches"]["isect_bvh_any"],
            launches_config_a_direct_mis=slice_runs["config_a_direct_mis"]["launches"][
                "isect_bvh_any"],
            launches_cli_test_furnace_bvh=fe_tests["furnace_bvh"]["launches"]["isect_bvh_any"],
            launches_wavefront_config_a=wave_launches["config_a_path_mis_1spp"][
                "isect_bvh_any"],
            wavefront_iterations_config_a=wave_iters["config_a_path_mis_1spp"],
            shadow=bvh_rows["any_shadow"], ptxas=bvh_regs),
        row("isect_brute", ISECT_SOURCE, "optix_renderer_tpu/ops/pallas/mxu_intersect.py:195",
            launches_b["isect_brute"], err_brute, ms_brute, plain_brute, b_brute, rays=MAIN_RAYS,
            also_replaces="optix_renderer_tpu/ops/pallas/mt_kernel.py:140",
            kernel="brute_kernel (persistent blocks, table staged once, 4 rays per thread)",
            shape=f"{MAIN_RAYS} rays x 12 triangles, kernel alone (torch.profiler)",
            wrapper_ms=wrapper_brute, sets=brute_rows, launches_b252=launches_b252["isect_brute"],
            launches_scan_slice={k: v["launches"]["isect_brute"] for k, v in slice_runs.items()},
            launches_train_step=train_row["launches"]["isect_brute"],
            launches_gradient_config_h_forward=grad_rows["config_h_path_vol_mis_depth8"][
                "forward_launches"]["isect_brute"],
            launches_adaptive_render=ad_row["launches"]["isect_brute"],
            launches_photon_render=pmap_counts["isect_brute"],
            launches_photon_build=build_counts["isect_brute"],
            launches_photon_cornell_48x48=pm_small["cornell_48x48"]["launches"]["isect_brute"],
            launches_cli_test_furnace_brute=fe_tests["furnace_brute"]["launches"][
                "isect_brute"],
            max_abs_err_cli_test_furnace_brute=front[26]["kernel_max_abs_err"]["furnace_brute"],
            launches_serve_cornell=front[28]["launches"]["isect_brute"],
            serve_rounds_timed=front[28]["rounds_timed"],
            ptxas=brute_regs, instructions_per_pair=brute_loops,
            launches_sharded=shard_rec["scan_path"]["launches"],
            max_abs_err_sharded=shard_rec["scan_path"]["max_abs_err"],
            launches_spheres_render=sph["render"]["launches"]["isect_brute"],
            launches_wavefront={k: v["isect_brute"] for k, v in wave_launches.items()
                                if k.startswith("cornell")},
            wavefront_iterations={k: v for k, v in wave_iters.items() if k.startswith("cornell")},
            wavefront_config_b=wave["config_b"],
            wavefront_cornell_gaussian_16spp=wave["cornell_gaussian_16spp"],
            wavefront_splat_ms=wave["splat_ms"],
            sharded_train_step=shard_rec["train_step"], multihost=mh_rec),
        row("pathk_trace_medium", KERNEL_SOURCE, REPLACES, launches_m, err_medium, medium_ms,
            medium_plain_ms, walk_bound, branch="MXU, optix_renderer_tpu/ops/pallas/pathk.py:622",
            kernel="pathk_staged_kernel<MIS> (LBVH walk, csrc/walk.cuh)",
            shape="800x600 x 16 spp", plain_shape=f"rows 0-{M_REF_ROWS - 1} of 800x600 x 16 spp",
            ms_at_plain_shape=medium_ref_ms, iterations=iters_m,
            median_rel_err=st_m["median_rel_err"], walk_ops_per_ray=walk_ray_ops,
            old_sweep_bound_ms=sweep_bound[0], ptxas=medium_regs,
            launches_sharded=kp["config_m_cuda0_x4"]["launches"],
            max_abs_err_sharded=kp["config_m_cuda0_x4"]["max_abs_err"],
            launches_sharded_all_cards=kp["config_m_all_cards"]["launches"],
            split_launch_equal=shard_rec["split_launch"]["medium"]["equal"]),
        row("probe_copy", PROBES_SOURCE, "tools/probe_mosaic.py:50", launches_pc, err_pc, pc_ms,
            pc_plain_ms, pc_bound, wrapper_ms=pc_wrapper_ms, ms_behind_spin=pc_spin_ms,
            latency_floor_ms=pc_alone["floor"], latency_floor_behind_spin_ms=floor_spin_ms,
            torch_yardstick_ms=pc_alone["yardstick"],
            torch_yardstick_note="index_select, then two sums: several calls that add in "
                                 "other orders, so a yardstick of time only",
            kernel="probe_copy_kernel (128 CTAs in clusters of 8, one tensor copy each)",
            sms=pc_sms),
        row("iter_cost", PROBES_SOURCE, "tools/prof_parts2.py:40", launches_ic, err_ic,
            parts["isect"]["ms"][64], ic_plain["isect"], ic_bound, shape="isect, 64 iterations",
            bound_half_rate_ms=ic_half, issue_limit_ms=ic_issue,
            instructions_per_lane_triangle=ic_per_pair,
            kernel="iter_cost_kernel<MODE> (4 CTAs of 1,024 threads per group; reduce in "
                   "clusters)",
            modes={m: {"ms_64": r["ms"][64], "ms_1024": r["ms"][1024],
                       "us_per_iter": r["us_per_iter"], "ns_per_lane_iter": r["ns_per_lane_iter"],
                       "plain_ms_64": ic_plain[m], "sms": ic_sms[m]}
                   for m, r in parts.items()}),
        *(row(name, TRACK_SOURCE, f"optix_renderer_tpu/ops/volume_grid.py:{line}",
              media_runs["config_h_path_vol_mis"]["launches"][name], r["err"], r["ms"],
              r["plain_ms"], r["bound"], ms_behind_spin=r["ms_behind_spin"], sum_k=r["sum_k"],
              L=r["L"], lanes=r["lanes"], shape=shape,
              kernel=f"walk_kernel<{ratio}> + advance_kernel (one thread per lane, then "
                     "pcg32 jump-ahead by the lockstep draws)",
              no_pallas_counterpart="replaces the XLA lax.while_loop", ptxas=track_regs,
              launches_per_render={k: v["launches"][name] for k, v in media_runs.items()},
              launches_gradient_config_h_forward=grad_rows["config_h_path_vol_mis_depth8"][
                  "forward_launches"][name])
          for name, line, r, ratio, shape in (
              ("delta_track", 124, delta_row, "false", "config H's 480,000 camera rays"),
              ("ratio_track", 202, ratio_row, "true", "480,000 shadow rays toward the light"))),
        row("isect_spheres", ISECT_SOURCE, "optix_renderer_tpu/ops/bvh.py:517",
            sph["render"]["launches"]["isect_spheres_closest"]
            + sph["render"]["launches"]["isect_spheres_any"],
            sph["closest_camera"]["max_abs_err"],
            sph["closest_camera"]["ms"], sph["closest_camera"]["plain_ms"],
            sph["closest_camera"]["bound"],
            no_pallas_counterpart="replaces the XLA lax.while_loop of _traverse_spheres_walk",
            kernel="bvh_kernel<ANY, SphLeaf> (the child-pair walk of isect_bvh, sphere leaves)",
            shape=f"{sph['rays']} camera rays x 10,000 spheres, CUDA events behind a spin",
            launches_closest=sph["render"]["launches"]["isect_spheres_closest"],
            launches_any=sph["render"]["launches"]["isect_spheres_any"],
            camera=sph["closest_camera"], shadow=sph["any_shadow"],
            render=sph["render"], card_vs_cpu=sph["card_vs_cpu_64x48"], ptxas=sph["ptxas"]),
        row("lbvh_build", LBVH_SOURCE, LBVH_REPLACES, lb["launches"], lb["max_abs_err"],
            lb["sizes"]["config_a_100012"]["ms"], lb["sizes"]["config_a_100012"]["plain_ms"],
            (lb["sizes"]["config_a_100012"]["bound_ms"],
             lb["sizes"]["config_a_100012"]["bound_by"]),
            no_pallas_counterpart="the JAX package builds on the host: ops/bvh.py:160 "
                                  "build_lbvh_host",
            kernel="bounds_kernel, keys_kernel, torch.sort, leaf_kernel, box_kernel per level, "
                   "torch.sort, rowof_kernel, pairs_kernel (one chain per tree)",
            shape="config A's 100,012 triangles, CUDA events, median of 5",
            plain="the numpy builder (ops/bvh.py: build_bvh_tables + pack_child_pairs) on the "
                  "host, then its tables uploaded",
            library_note="no one PyTorch call builds an LBVH; the chain's two torch.sort "
                         "calls, timed apart on as many int64 keys, in sort_ms / sort_share",
            sort_ms=lb["sizes"]["config_a_100012"]["sort_ms"],
            sort_share=lb["sizes"]["config_a_100012"]["sort_share"],
            sizes=lb["sizes"], load_scene_s=lb["load_scene_s"], scene_to_ms=lb["scene_to_ms"],
            config_a=lb["config_a"]),
        row("scan_shade", SCAN_SOURCE, "optix_renderer_tpu/integrators/path.py (li_path_mis / "
            "li_path_mats' bounce)", shade_launches_a["scan_shade"] + shade_launches_a["scan_fold"],
            shd_a["L_max_abs_err"], shd_a["ms"], shd_a["plain_ms"], shd_a["bound"],
            no_pallas_counterpart="the JAX scan path's bounce is XLA",
            kernel="shade_kernel<MIS> (one thread per lane, a dead lane returning after its fold)",
            shape="config A's 480,000 camera rays, depth 8, per launch (folds included)",
            launches_shade=shade_launches_a["scan_shade"],
            launches_fold=shade_launches_a["scan_fold"], runs=shd),
        row("film_splat", FILM_SOURCE, "optix_renderer_tpu/render/film.py: splat (an XLA "
            "scatter, .at[].add)", splat_launches_a, spl_a["max_abs_err"], spl_a["ms"],
            spl_a["plain_ms"], spl_a["bound"],
            no_pallas_counterpart="the JAX package splats with XLA's scatter",
            kernel="splat_kernel<F> (one thread per lane, float4 atomic adds)",
            shape="config A's round at 800x600: one chunk of 480,000 lanes, gaussian, "
                  "per launch",
            runs=spl),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
