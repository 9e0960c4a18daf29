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
6. runs the CLI on the GPU and checks it writes EXR and PNG.

Every phase raises on failure. The second-to-last line is a JSON object with
the kernel's route, source, launches, error and times; the last line is
{"ok": true, "device": {...}}.
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


def main() -> None:
    # ---- 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phase(1, f"gpu: {smi}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from optix_renderer_tpu_torch.ops.cuda import _build, pathk
    from optix_renderer_tpu_torch.render.render import _layers_out, render
    from optix_renderer_tpu_torch.scene.presets import cornell_box_xml, make_cornell_box
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
    print(f"  800x600 x 16 spp: kernel {kernel_ms:.3f} ms, plain version {plain_ms:.3f} ms "
          f"on {smi}")
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

    print(json.dumps({"kernels": [{
        "name": "pathk_trace", "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES,
        "launches": launches, "max_abs_err": stats["max_abs_err"],
        "median_rel_err": stats["median_rel_err"], "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
