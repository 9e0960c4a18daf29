"""Command-line interface: render scenes, tonemap EXRs, run statistical and
warp tests, train the denoiser.

Counterpart of `optix_renderer_tpu/cli.py` (the reference executables,
CMakeLists.txt:27,147,175), with the flags this package covers and
`--device`:
- `render` = the headless `nori scene.xml` path (src/utils/main.cpp:81-104):
  renders, writes `<scene>.exr` and a tonemapped PNG. A scene with
  `<sampler type="adaptive">` renders through `render/adaptive.py` (unless
  `--no-adaptive`) and also writes `<out>_variance.exr`. `--denoise
  [bilateral|learned]`, or a scene's `<denoiser>` without the flag
  (`simple` is the bilateral filter), also writes `<out>_denoised.exr` /
  `.png`. `--serve` renders behind the live view (`serve.py`).
  `--sharded` renders over a mesh of `--local-devices` entries (default
  every visible card; `parallel/shard.py`), `--distributed` over the
  processes of a `torch.distributed` group (`parallel/multihost.py`; only
  rank 0 writes files). A `<test>` root runs its statistical test instead
  and returns 0 or 1;
- `scaling` = paths/s on one device against the whole mesh, as JSON;
- `test` = a `<test type="ttest"|"chi2test">` XML (`validation/xmltest.py`);
- `tonemap` = the `tonemapper` EXR→PNG batch converter (hdrToLdr.cpp:22-40);
- `warptest` = the χ² warp validation suite, headless (warptest.cpp:439-561);
- `train-denoiser` trains the learned denoiser.

There is no fallback: `--device cuda` without a GPU fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np


def _distributed_mesh(args):
    """With `--distributed`, join the process group (cli.py:21-37 of the JAX
    package) and return the global mesh of this rank's entries; else None."""
    if not args.distributed:
        return None
    from optix_renderer_tpu_torch.parallel.multihost import init_distributed, make_multihost_mesh

    return make_multihost_mesh(devices=init_distributed(
        args.coordinator, args.num_processes, args.process_id, backend=args.backend,
        device=args.device, local_devices=args.local_devices))


def _local_mesh(args):
    """The one-process mesh of `--sharded` / `scaling`: `--local-devices`
    entries of a CPU device, or of every visible card (by default each
    card once)."""
    import torch

    from optix_renderer_tpu_torch.parallel.shard import make_mesh
    from optix_renderer_tpu_torch.render.render import resolve_device

    resolve_device(args.device)
    cards = ([torch.device("cpu")] if args.device == "cpu" else
             [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    return make_mesh(devices=cards * (args.local_devices or 1))


def cmd_render(args) -> int:
    from optix_renderer_tpu_torch.render.adaptive import render_adaptive
    from optix_renderer_tpu_torch.render.render import render, resolve_device
    from optix_renderer_tpu_torch.scene.build import build_scene
    from optix_renderer_tpu_torch.scene.parser import load_from_xml
    from optix_renderer_tpu_torch.utils import imageio as iio

    device = resolve_device(args.device)
    mh_mesh = _distributed_mesh(args)
    # a <test> root executes its statistical test instead of rendering, as
    # the reference runs ttest / chi2test scene objects on load
    # (ttest.cpp:81-95)
    root = load_from_xml(args.scene)
    if root.tag == "test":
        from optix_renderer_tpu_torch.validation import run_xml_test

        return 0 if run_xml_test(root, device=device).ok else 1
    scene, config, _ = build_scene(root, device)
    overrides = {}
    if args.spp:
        overrides["sample_count"] = args.spp
    if args.size:
        w, h = (int(x) for x in args.size.lower().split("x"))
        overrides["width"], overrides["height"] = w, h
    if args.integrator:
        overrides["integrator"] = args.integrator
    if args.depth:
        overrides["max_depth"] = args.depth
    if overrides:
        config = dataclasses.replace(config, **overrides)
    if args.resume and not args.checkpoint:
        print("warning: --resume has no effect without --checkpoint")

    out_base = Path(args.output) if args.output else Path(args.scene).with_suffix("")
    adaptive = config.adaptive and not args.no_adaptive
    if adaptive and (args.serve or args.sharded or mh_mesh):
        # the live loop and the mesh render uniform rounds (serve.py,
        # parallel/); say so rather than ignore the scene's
        # <sampler type="adaptive">
        print("warning: adaptive sampler is ignored under --sharded/--distributed/--serve "
              "(uniform sampling used)")
        adaptive = False
    print(f"Rendering {args.scene}: {config.width}x{config.height} @ "
          f"{config.sample_count}spp, integrator={config.integrator}, device={device}"
          + (" [adaptive]" if adaptive else ""))
    preview_cb = None
    if args.preview_every:
        def preview_cb(layers, spp_done):
            iio.write_png(str(out_base) + "_preview.png", layers["composite"])
            if args.verbose:
                print(f"  preview @ {spp_done}spp → {out_base}_preview.png")

    t0 = time.time()
    if args.serve:
        from optix_renderer_tpu_torch.serve import serve_render

        out = serve_render(scene, config, port=args.port, host=args.host, device=device)
    elif mh_mesh:
        import torch.distributed as dist

        from optix_renderer_tpu_torch.parallel.multihost import render_multihost

        out = render_multihost(
            scene, config, mh_mesh, verbose=args.verbose,
            preview_every=args.preview_every, preview_callback=preview_cb,
            checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
            resume=args.resume,
        )
        if dist.get_rank() != 0:
            return 0  # every rank holds the film; rank 0 writes it
    elif args.sharded:
        from optix_renderer_tpu_torch.parallel.shard import render_sharded

        mesh = _local_mesh(args)
        print(f"  mesh {mesh.shape}: {', '.join(map(str, mesh.flat))}")
        out = render_sharded(
            scene, config, mesh, verbose=args.verbose,
            preview_every=args.preview_every, preview_callback=preview_cb,
            checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
            resume=args.resume,
        )
    elif adaptive:
        out = render_adaptive(scene, config, verbose=args.verbose, device=device)
    else:
        out = render(
            scene, config, device=device, verbose=args.verbose,
            preview_every=args.preview_every, preview_callback=preview_cb,
            checkpoint_path=args.checkpoint, checkpoint_every=args.checkpoint_every,
            resume=args.resume,
        )
    dt = time.time() - t0
    exr_path = out_base.with_suffix(".exr")
    iio.write_exr(exr_path, out["composite"])
    iio.write_png(out_base.with_suffix(".png"), out["composite"])
    if "variance" in out:
        iio.write_exr(str(out_base) + "_variance.exr",
                      out["variance"][..., None].repeat(3, axis=-1))
    denoise = args.denoise or {"simple": "bilateral"}.get(config.denoiser, config.denoiser)
    if denoise:
        den = _denoise(out, config, denoise, args.denoiser_ckpt, device)
        iio.write_exr(str(out_base) + "_denoised.exr", den)
        iio.write_png(str(out_base) + "_denoised.png", den)
    n_paths = out.get("samples_placed", config.width * config.height
                      * out.get("spp_done", config.sample_count))
    if adaptive:
        print(f"  adaptive: {n_paths} samples placed in "
              f"{n_paths // (config.width * config.height)} rounds")
    print(f"Done in {dt:.1f}s ({n_paths / dt / 1e6:.2f} Mpaths/s) → {exr_path}")
    return 0


def _denoise(out: dict, config, mode: str, ckpt: str, device) -> np.ndarray:
    """The denoised composite [H,W,3] of a render's layers `out`, on `device`
    (cli.py:152-204 of the JAX package)."""
    import os

    import torch

    from optix_renderer_tpu_torch.denoise import learned
    from optix_renderer_tpu_torch.denoise.bilateral import denoise_bilateral
    from optix_renderer_tpu_torch.render.render import _norm_ckpt_path
    from optix_renderer_tpu_torch.render.variance import variance_from_image

    def dev(key):
        return torch.as_tensor(np.asarray(out[key], np.float32)).to(device)

    if mode == "learned" and not os.path.exists(_norm_ckpt_path(ckpt)):
        # the JAX package's documented behaviour for a missing checkpoint:
        # the bilateral filter, on the same device, said on stdout
        print(f"warning: denoiser checkpoint {_norm_ckpt_path(ckpt)} not found — "
              "falling back to bilateral (train one with `train-denoiser`)")
        mode = "bilateral"
    if mode == "learned":
        params = learned.load_checkpoint(ckpt, device)
        den = learned.apply(params, dev("composite"), dev("albedo"), dev("normal"))
    else:
        # the variance of the film as the JAX CLI forms it: the composite
        # beside the filter weights, divided once more by them
        film = torch.cat([dev("composite"), dev("weights")[..., None]], dim=-1)
        den = denoise_bilateral(
            dev("composite"), variance_from_image(film),
            sigma_d=float(config.dprop("sigma_d", 1.0)),
            sigma_vr=float(config.dprop("sigma_vr", 0.6)),
            inner_range=min(int(config.dprop("range", 1)), 3),
        )
    return den.detach().cpu().numpy()


def cmd_train_denoiser(args) -> int:
    """Train the learned denoiser on self-rendered noisy / clean pairs of each
    `--scene` (repeatable; default the built-in Cornell box) at `--size`
    wide, 3/4 as high, and save the checkpoint (cli.py:213-257 of the JAX
    package)."""
    from optix_renderer_tpu_torch.denoise import learned
    from optix_renderer_tpu_torch.render.render import resolve_device
    from optix_renderer_tpu_torch.scene.build import load_scene
    from optix_renderer_tpu_torch.scene.presets import make_cornell_box

    device = resolve_device(args.device)
    scenes = []
    for path in args.scene or ():
        scene, config, _ = load_scene(path, device)
        scenes.append((path, scene, dataclasses.replace(config, width=args.size,
                                                        height=args.size * 3 // 4)))
    if not scenes:
        scene, config, _ = make_cornell_box(width=args.size, height=args.size * 3 // 4, spp=1,
                                            device=device)
        scenes.append(("cornell(builtin)", scene, config))
    pairs = []
    for name, scene, config in scenes:
        print(f"rendering training pairs from {name}…")
        pairs += learned.render_training_pairs(scene, config, spps=(2, 4),
                                               clean_spp=args.clean_spp, device=device)
    print(f"training on {len(pairs)} pairs, {args.steps} steps, device={device}…")
    params, losses = learned.train(pairs, steps=args.steps, verbose=True, device=device)
    learned.save_checkpoint(args.output, params)
    print(f"loss {losses[0]:.5f} → {losses[-1]:.5f}; saved {args.output}")
    return 0


def cmd_scaling(args) -> int:
    """Paths/s on one device against the whole mesh, as JSON (cli.py:260-282
    of the JAX package): the mesh of `--local-devices` entries, or with
    `--distributed` every rank's; rank 0 writes `--output`. With one device
    the efficiency is 1 by construction: a scaling number needs more cards."""
    from optix_renderer_tpu_torch.parallel.multihost import measure_scaling
    from optix_renderer_tpu_torch.render.render import resolve_device

    mesh = _distributed_mesh(args) or _local_mesh(args)
    device = resolve_device(args.device)
    if args.scene:
        from optix_renderer_tpu_torch.scene.build import load_scene

        scene, config, _ = load_scene(args.scene, device)
    else:
        from optix_renderer_tpu_torch.scene.presets import make_cornell_box

        scene, config, _ = make_cornell_box(width=args.size, height=args.size * 3 // 4,
                                            spp=args.spp, device=device)
    config = dataclasses.replace(config, sample_count=args.spp)
    res = measure_scaling(scene, config, spp=args.spp, out_path=args.output, mesh=mesh)
    print(json.dumps(res, indent=1))
    return 0


def cmd_tonemap(args) -> int:
    from optix_renderer_tpu_torch.utils import imageio as iio

    for f in args.files:
        img = iio.read_exr(f)[..., :3] * args.exposure
        out = Path(f).with_suffix(".png")
        iio.write_png(out, img)
        print(f"{f} → {out}")
    return 0


def cmd_test(args) -> int:
    from optix_renderer_tpu_torch.validation import run_xml_test

    report = run_xml_test(args.scene, sample_scale=args.sample_scale, device=args.device)
    return 0 if report.ok else 1


def cmd_warptest(args) -> int:
    """Headless χ² suite over every warp (warptest.cpp without the GUI): each
    warp and its pdf run on `--device`, on the numpy uniforms and directions
    of `chi2_sphere_test`, and hand numpy back to it."""
    import torch

    from optix_renderer_tpu_torch.core import warp
    from optix_renderer_tpu_torch.render.render import resolve_device
    from optix_renderer_tpu_torch.utils.hypothesis import chi2_sphere_test

    device = resolve_device(args.device)

    def on_device(fn, *params):
        return lambda x: fn(torch.from_numpy(x).to(device), *params).cpu().numpy()

    half = torch.tensor(0.5, device=device)
    cases = [
        ("uniform_sphere", warp.square_to_uniform_sphere, warp.square_to_uniform_sphere_pdf, (), {}),
        ("uniform_hemisphere", warp.square_to_uniform_hemisphere,
         warp.square_to_uniform_hemisphere_pdf, (), {}),
        ("cosine_hemisphere", warp.square_to_cosine_hemisphere,
         warp.square_to_cosine_hemisphere_pdf, (), {}),
        ("beckmann a=0.3", warp.square_to_beckmann, warp.square_to_beckmann_pdf, (0.3,),
         {"theta_res": 20}),
        ("hg g=0.5", warp.square_to_henyey_greenstein, warp.square_to_henyey_greenstein_pdf,
         (half,), {}),
        ("schlick k=0.5", warp.square_to_schlick, warp.square_to_schlick_pdf, (half,), {}),
        ("sphere_cap c=0.5", warp.square_to_uniform_sphere_cap,
         warp.square_to_uniform_sphere_cap_pdf, (0.5,), {"theta_res": 20}),
    ]
    failures = 0
    for name, sample_fn, pdf_fn, params, kw in cases:
        ok, msg = chi2_sphere_test(on_device(sample_fn, *params), on_device(pdf_fn, *params), **kw)
        print(f"{'PASS' if ok else 'FAIL'}  {name:24s} {msg}")
        failures += 0 if ok else 1
    return 1 if failures else 0


def _add_mesh_flags(sp) -> None:
    """The mesh and process-group flags (cli.py:328-340 of the JAX package,
    `--local-cpu-devices` becoming `--local-devices` beside `--device`)."""
    sp.add_argument("--local-devices", type=int, metavar="N",
                    help="entries of this process's mesh: N CPU entries with --device cpu, "
                    "each card N times with --device cuda (default: every card once)")
    sp.add_argument("--distributed", action="store_true",
                    help="render over the processes of a torch.distributed group")
    sp.add_argument("--coordinator", help="rank 0's address, e.g. host0:9876 (without it, "
                    "the env:// variables that torchrun sets)")
    sp.add_argument("--num-processes", type=int)
    sp.add_argument("--process-id", type=int)
    sp.add_argument("--backend", choices=["nccl", "gloo"], default="nccl",
                    help="nccl for ranks on cards of their own; gloo for CPU ranks and for "
                    "ranks that share one card")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="optix_renderer_tpu_torch",
                                description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("render", help="render a scene XML")
    pr.add_argument("scene")
    pr.add_argument("-o", "--output", help="output basename (default: scene name)")
    pr.add_argument("--spp", type=int, help="override sample count")
    pr.add_argument("--size", help="override resolution, e.g. 800x600")
    pr.add_argument("--integrator", help="override integrator: normals, av, direct, direct_ems, "
                    "direct_mats, direct_mis, preview, envmaptester, path_mats, path_mis, "
                    "path_vol_mats, path_vol_mis, photonmapper")
    pr.add_argument("--depth", type=int, help="max path depth")
    pr.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda launches the CUDA kernels; cpu runs their plain torch versions")
    pr.add_argument("--preview-every", type=int, default=0, metavar="K",
                    help="write a progressive preview PNG every K samples")
    pr.add_argument("--checkpoint", metavar="PATH", help="accumulator snapshot path")
    pr.add_argument("--checkpoint-every", type=int, default=8, metavar="K",
                    help="snapshot every K samples (with --checkpoint)")
    pr.add_argument("--resume", action="store_true",
                    help="continue from --checkpoint if it exists")
    pr.add_argument("--no-adaptive", action="store_true",
                    help="render a <sampler type=\"adaptive\"> scene uniformly")
    pr.add_argument("--denoise", nargs="?", const="bilateral", choices=["bilateral", "learned"],
                    default=None, help="also write <out>_denoised: bilateral (simple.cpp) or "
                    "learned (the AI-denoiser analog)")
    pr.add_argument("--denoiser-ckpt", default="denoiser.npz",
                    help="checkpoint for --denoise learned")
    pr.add_argument("--serve", action="store_true",
                    help="live-view web server with pause / resume and live property edits")
    pr.add_argument("--port", type=int, default=8000, help="port for --serve")
    pr.add_argument("--host", default="127.0.0.1",
                    help="bind address for --serve (loopback by default; the server is "
                    "unauthenticated: use 0.0.0.0 only on trusted networks)")
    pr.add_argument("--sharded", action="store_true",
                    help="render over a mesh of devices (--local-devices)")
    pr.add_argument("-v", "--verbose", action="store_true")
    _add_mesh_flags(pr)
    pr.set_defaults(fn=cmd_render)
    ps = sub.add_parser("scaling", help="measure 1-device vs full-mesh scaling efficiency")
    ps.add_argument("--scene", help="scene XML (default: the built-in Cornell box)")
    ps.add_argument("--spp", type=int, default=4)
    ps.add_argument("--size", type=int, default=256)
    ps.add_argument("-o", "--output", default="scaling.json")
    ps.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device of the mesh's entries")
    _add_mesh_flags(ps)
    ps.set_defaults(fn=cmd_scaling)
    pd = sub.add_parser("train-denoiser", help="train the learned denoiser on self-rendered pairs")
    pd.add_argument("--scene", action="append",
                    help="scene XML, repeatable (default: the built-in Cornell box)")
    pd.add_argument("-o", "--output", default="denoiser.npz")
    pd.add_argument("--steps", type=int, default=300)
    pd.add_argument("--size", type=int, default=128)
    pd.add_argument("--clean-spp", type=int, default=256)
    pd.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda renders and trains on the GPU; cpu on the CPU")
    pd.set_defaults(fn=cmd_train_denoiser)
    pt = sub.add_parser("tonemap", help="EXR → PNG")
    pt.add_argument("files", nargs="+")
    pt.add_argument("--exposure", type=float, default=1.0)
    pt.set_defaults(fn=cmd_tonemap)
    pw = sub.add_parser("warptest", help="chi^2 warp validation suite")
    pw.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device on which the warps and their pdfs run")
    pw.set_defaults(fn=cmd_warptest)
    px = sub.add_parser("test", help="run a <test type=ttest|chi2test> XML "
                        "(ttest.cpp / chi2test.cpp)")
    px.add_argument("scene")
    px.add_argument("--sample-scale", type=float, default=1.0,
                    help="scale all sample counts (fast runs)")
    px.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda launches the CUDA kernels; cpu runs their plain torch versions")
    px.set_defaults(fn=cmd_test)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
