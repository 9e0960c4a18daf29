"""One run of one cell: set-up, the measured window, the traced slice, the check.

The program under test is `optix_renderer_tpu_torch`; the run takes from it
only `scene.build.load_scene` (the system's entry for a scene file) and
`render.render.render` (the entry of a render, which ends with the film on
the host), and the profiler's view of its kernels. Everything else (the
scenes, the seeds, the timing, the metrics, the reference) is the
benchmark's own.
"""

from __future__ import annotations

import dataclasses
import gc
import random
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from harness import manifest
from harness.check import judge

M31 = 2**31 - 1
SEED_SPAN = 10**7  # render seeds run base, base + 1, …: fewer than this per run


@dataclass
class Run:
    """What the metric readers read (`metrics/<name>.py: read(run)`)."""

    cell: manifest.Cell
    spp: int
    setup_s: float
    scene_load_s: float
    window_start: float
    renders: list  # [(start, end, camera paths)] of the window, host clock
    trace: object = None  # harness.profile.TraceSlice of a --trace 1 run


def base_seed(seed: int) -> int:
    """The first render seed of a run, drawn from --seed. The window's renders
    take base + i, the warm-up base + SEED_SPAN and the traced slice base +
    2·SEED_SPAN + k, all below 2^31: the renderer takes a 32-bit signed seed."""
    return int(np.random.default_rng(seed & (2**64 - 1)).integers(0, M31 - 3 * SEED_SPAN))


def apply_overrides(cell: manifest.Cell, overrides: dict | None) -> manifest.Cell:
    """A copy of the cell with entries of its configuration's `scene`, its
    traffic and its check replaced (for the harness's CPU tests)."""
    if not overrides:
        return cell
    cfg = dict(cell.config, scene=dict(cell.config["scene"], **overrides.get("scene", {})))
    traffic = manifest.traffic_plan(dict(cell.traffic, **overrides.get("traffic", {})))
    return dataclasses.replace(cell, config=cfg, traffic=traffic,
                               check=dict(cell.check, **overrides.get("check", {})))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_start: float, *,
             device: str = "cuda", overrides: dict | None = None, render_fn=None,
             log=print) -> dict:
    """Run one cell and return the result line's object (without printing).

    The traffic is the generator's (`manifest.traffic_plan`): one client in
    a closed loop, request i rendered with seed base + i and the traffic's
    `render` keyword arguments. `device="cpu"`, `overrides` and `render_fn`
    exist for the harness's CPU tests: the benchmark's command always runs
    on the card, with the program's `render`."""
    import torch

    from optix_renderer_tpu_torch.render.render import render
    from optix_renderer_tpu_torch.scene.build import load_scene

    phases = [("imports and the look for cards", time.perf_counter())]

    render_fn = render if render_fn is None else render_fn
    cell = apply_overrides(manifest.load_cell(workload), overrides)
    cfg, traffic, check = cell.config, cell.traffic, cell.check
    scene_cfg = cfg["scene"]
    spp = int(traffic["spp"])
    render_kwargs = dict(traffic["render"])
    n_pix = scene_cfg["width"] * scene_cfg["height"]
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    base = base_seed(seed)

    tmp = Path(tempfile.mkdtemp(prefix="bench_scene_"))
    try:
        writer = manifest.resolve(cfg["writer"])
        xml = writer(tmp, **scene_cfg)
        phases.append(("scene files", time.perf_counter()))
        if on_card:  # the card's context first, so that scene_load_s times the scene alone
            torch.empty(1, device=device)
            sync()
        phases.append(("card", time.perf_counter()))
        t0 = time.perf_counter()
        scene, rcfg, _ = load_scene(xml, device=device)
        sync()
        scene_load_s = time.perf_counter() - t0
        phases.append(("load_scene", time.perf_counter()))
        rcfg = dataclasses.replace(rcfg, max_depth=int(cfg["max_depth"]))

        def one(render_seed: int):
            return render_fn(scene, dataclasses.replace(rcfg, seed=render_seed),
                             sample_count=spp, device=device, **render_kwargs)

        one(base + SEED_SPAN)  # warm-up, a seed the window does not use
        sync()
        window_start = time.perf_counter()
        setup_s = window_start - t_start
        phases.append(("warm-up", window_start))
        log("set-up: " + ", ".join(f"{name} {t - t_prev:.3f} s" for (name, t), t_prev in
                                   zip(phases, [t_start] + [t for _, t in phases[:-1]])),
            file=sys.stderr)

        # the closed loop: back-to-back renders of one client; a reservoir
        # keeps a uniform sample of the window's films for the check
        pick = random.Random(seed ^ 0x5EED)
        keep_n = int(check["renders"])
        kept, renders, failed, i = [], [], 0, 0
        while time.perf_counter() - window_start < seconds:
            r_seed = base + i
            s = time.perf_counter()
            try:
                film = one(r_seed)
            except Exception as exc:  # a failed request counts against the run
                failed += 1
                log(f"render {i} failed: {exc!r}", file=sys.stderr)
                film = None
            e = time.perf_counter()
            i += 1
            if film is None:
                continue
            renders.append((s, e, float(n_pix * spp)))
            if len(kept) < keep_n:
                kept.append((film, r_seed, spp))
            else:
                j = pick.randrange(len(renders))
                if j < keep_n:
                    kept[j] = (film, r_seed, spp)
            film = None
        attempted = i
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        if renders:
            d = sorted(1e3 * (e - s) for s, e, _ in renders)
            log(f"window: {len(d)} renders in {renders[-1][1] - window_start:.3f} s; ms per "
                f"render min {d[0]:.2f}, median {d[len(d) // 2]:.2f}, max {d[-1]:.2f}",
                file=sys.stderr)

        run = Run(cell=cell, spp=spp, setup_s=setup_s,
                  scene_load_s=scene_load_s, window_start=window_start, renders=renders)
        if trace:
            from harness.profile import profile_renders

            n_tr = int(traffic["trace_renders"])
            k = iter(range(base + 2 * SEED_SPAN, base + 3 * SEED_SPAN))
            run.trace = profile_renders(lambda: one(next(k)), n_tr, float(n_pix * spp),
                                        float(n_pix))

        # the program's state goes before the reference runs on the card
        del scene, one
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        numbers = judge(kept, xml, cfg, check, seed, device)
        log(f"reference: {numbers['pixels']} pixels of {len(kept)} renders in "
            f"{time.perf_counter() - t_ref:.2f} s; largest error {numbers['max_err']:.3g}, "
            f"median {numbers['median_err']:.3g}", file=sys.stderr)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    limits = check["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and bool(renders) and all(
        v["value"] <= v["limit"] for v in checks.values())

    metrics = {}
    for m in manifest.metrics_for(cell.manifest, workload, trace):
        try:
            value = manifest.metric_reader(m.name)(run)
        except ValueError:  # nothing to read: no render finished in the window
            value = None
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown
    out["check"] = checks
    return out
