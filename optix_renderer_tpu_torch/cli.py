"""Command-line interface: `render` a scene XML to EXR + PNG.

Counterpart of the `render` subcommand of `optix_renderer_tpu/cli.py` (the
headless `nori scene.xml` path, src/utils/main.cpp:81-104), with the flags
this package covers and `--device`. A scene with `<sampler type="adaptive">`
renders through `render/adaptive.py` (unless `--no-adaptive`) and also
writes `<out>_variance.exr`. There is no fallback: `--device cuda`
without a GPU fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path


def cmd_render(args) -> int:
    from optix_renderer_tpu_torch.render.adaptive import render_adaptive
    from optix_renderer_tpu_torch.render.render import render, resolve_device
    from optix_renderer_tpu_torch.scene.build import load_scene
    from optix_renderer_tpu_torch.utils import imageio as iio

    device = resolve_device(args.device)
    scene, config, _ = load_scene(args.scene)
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
    if adaptive:
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
    n_paths = out.get("samples_placed", config.width * config.height * config.sample_count)
    if adaptive:
        print(f"  adaptive: {n_paths} samples placed in "
              f"{n_paths // (config.width * config.height)} rounds")
    print(f"Done in {dt:.1f}s ({n_paths / dt / 1e6:.2f} Mpaths/s) → {exr_path}")
    return 0


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
                    "path_vol_mats, path_vol_mis")
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
    pr.add_argument("-v", "--verbose", action="store_true")
    pr.set_defaults(fn=cmd_render)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
